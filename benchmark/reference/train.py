"""The plain reference of the detection train step, frozen from the
port's ``parallel/train_state.py`` and ``models/univs.py``: the training
forward (the decoder's temporal query shuffle drawn at the same keys),
the frozen criterion (``losses/criterion.py``), and per label group
('backbone', 'rest') the clip by the group's global norm, Adam
(b1 0.9, b2 0.999, eps 1e-8 on sqrt(v_hat)), decoupled weight decay
under the decay mask and the learning-rate schedule, all in float32 on
float32 weights.  The Swin blocks, the pixel decoder's encoder layers
and the decoder's heads are recomputed in the backward (exact: none of
them draws), so that float32 fits the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.config import UniVSConfig
from benchmark.reference.losses.criterion import TrainTargets, UniCriterion
from benchmark.reference.models.backbones.resnet import FrozenBatchNorm
from benchmark.reference.models.decoder import draw_shuffle_perms
from benchmark.reference.structures import TextPrompts

B1, B2, EPS = 0.9, 0.999, 1e-8
EMBED_NAMES = ("query_feat", "query_embed", "level_embed", "cls_temp", "reid_temp",
               "prompt_detection", "prompt_sot", "prompt_grounding")


def _leaf_paths(model: nn.Module, key: str) -> List[Tuple[Tuple[str, ...], int]]:
    """The flax leaves (path, rank) a parameter comes from: a Linear /
    Conv ``weight`` from ``kernel``, a norm's ``weight`` from ``scale``,
    frozen BN's tensors from scale / bias / mean / var, the pixel
    decoder's level embeddings from ``level_embed_{i}``."""
    mod_path, name = key.rsplit(".", 1) if "." in key else ("", key)
    mod = model.get_submodule(mod_path)
    t = dict(mod.named_parameters(recurse=False)).get(name)
    path = tuple(mod_path.split(".")) if mod_path else ()
    if isinstance(mod, FrozenBatchNorm):
        return [(path + ({"weight": "scale", "bias": "bias", "running_mean": "mean",
                          "running_var": "var"}[name],), 1)]
    if name == "weight" and isinstance(mod, (nn.Linear, nn.Conv2d)):
        return [(path + ("kernel",), t.dim())]
    if name == "weight" and isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
        return [(path + ("scale",), 1)]
    if name == "level_embed" and mod_path.startswith("pixel_decoder"):
        return [(path + (f"level_embed_{i}",), 1) for i in range(t.shape[0])]
    return [(path + (name,), t.dim())]


def _decays(path, ndim: int) -> bool:
    is_norm = any("norm" in k.lower() or k in ("scale", "bias", "mean", "var") for k in path[-2:])
    is_embed = any(k in EMBED_NAMES for k in path)
    return not (is_norm or is_embed or ndim <= 1)


def lr_at(c, step: int) -> float:
    """The multistep schedule (the configurations' family): linear warmup
    from ``warmup_factor``, x ``lr_gamma`` at each of ``lr_steps``."""
    if c.lr_scheduler != "multistep":
        raise ValueError(f"the reference follows the multistep schedule, not {c.lr_scheduler!r}")
    f32 = np.float32
    warm = f32(1.0)
    if c.warmup_iters > 0 and c.warmup_factor < 1.0:
        a = f32(min(max(step / c.warmup_iters, 0.0), 1.0))
        warm = f32(c.warmup_factor * (1.0 - a) + a)
    n = sum(step >= b for b in sorted(c.lr_steps))
    return float(f32(c.lr) * warm * f32(c.lr_gamma ** n))


def forward_train(model, images, frame_indices, text_prompts, cls_emb, shuffle_key):
    """The detection training forward: normalize, backbone, pixel decoder,
    decoder with the drawn temporal shuffle."""
    cfg = model.cfg
    b, t, h, w, _ = images.shape
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=images.device)
    x = ((images.to(torch.float32) - mean) / std).reshape(b * t, h, w, 3)
    mask_features, _, _, ms = model.pixel_decoder(model.backbone(x))
    perms = None
    if model.decoder.temporal_query_shuffle and t > 1:
        perms = draw_shuffle_perms(shuffle_key, model.decoder.num_layers, t)
    return model.decoder(ms, mask_features, frame_indices, task="detection",
                         text_prompts=text_prompts, cls_emb=cls_emb, train=True,
                         shuffle_perms=perms)


def train_steps(model, batches: List[Dict[str, torch.Tensor]], key, steps: int) -> Dict:
    """``steps`` detection steps of ``model`` (trained in place) on
    ``batches[s]`` with the draws of ``key.fold_in(s)``.  A float32 model
    is its own masters; a model held in a lower dtype (its
    ``keep_float32`` leaves aside) computes in it over float32 masters, as
    the program trains: the gradients upcast, the masters updated, the
    model's weights copied from them with rounding.  Returns each step's
    total loss, each parameter's gradient as the optimizer gets it at the
    first step (clipped; norms by name, and the tensors on the host), and
    each parameter's change over the steps (norms by name)."""
    cfg: UniVSConfig = model.cfg
    c = cfg.train
    model.pixel_decoder.remat = True
    for mod in model.modules():  # frozen BN's statistics train, as the program's
        if isinstance(mod, FrozenBatchNorm):
            for name in ("running_mean", "running_var"):
                if name in mod._buffers:
                    mod.register_parameter(name, nn.Parameter(mod._buffers.pop(name)))
    criterion = UniCriterion(c, cfg.decoder.num_queries, cfg.num_frames)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    labels = {k: "backbone" if k.startswith("backbone.") else "rest" for k in named}
    decay = {k: all(_decays(path, nd) for path, nd in _leaf_paths(model, k)) for k in named}
    scale = {"backbone": c.backbone_lr_multiplier, "rest": 1.0}
    masters = {k: p.data if p.dtype == torch.float32 else p.detach().to(torch.float32)
               for k, p in named.items()}
    start = {k: m.clone() for k, m in masters.items()}
    mu = {k: torch.zeros_like(m) for k, m in masters.items()}
    nu = {k: torch.zeros_like(m) for k, m in masters.items()}
    losses, grad1, grad1_t = [], {}, {}
    model.train()
    for s in range(steps):
        b = batches[s]
        k = key.fold_in(s)
        _, r_crit, r_shuffle, _ = k.split(4)
        tp = TextPrompts(embs=b["prompt_category_embs"][:, :, None, :],
                         valid=b["prompt_category_valid"])
        targets = TrainTargets(labels=b["labels"], ids=b["ids"], masks=b["masks"],
                               valid=b["valid"], prompt_obj_ids=b["prompt_obj_ids"])
        for p in named.values():
            p.grad = None
        out = forward_train(model, b["images"], b["frame_indices"], tp, b["category_bank"],
                            r_shuffle)
        total, _ = criterion(r_crit, out, targets, b["category_bank_valid"], task="detection",
                             class_loss=True, sem_loss=True, level_sizes=None, tokens_per_prompt=1)
        total.backward()
        del out
        losses.append(float(total.detach()))
        bc1 = 1 - B1 ** (s + 1)
        bc2 = 1 - B2 ** (s + 1)
        lr = lr_at(c, s)
        with torch.no_grad():
            for group in ("backbone", "rest"):
                names = [n for n in named if labels[n] == group]
                if not names:
                    continue
                grads = [torch.zeros_like(masters[n]) if named[n].grad is None
                         else named[n].grad.to(torch.float32) for n in names]
                gnorm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
                factor = 1.0 if gnorm < c.clip_gradients_value else c.clip_gradients_value / gnorm
                for n, g in zip(names, grads):
                    g = g * factor
                    if s == 0:
                        grad1[n] = float(g.norm())
                        grad1_t[n] = g.to("cpu", copy=True)
                    mu[n].mul_(B1).add_(g, alpha=1 - B1)
                    nu[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                    upd = (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + EPS)
                    if decay[n]:
                        upd = upd + c.weight_decay * masters[n]
                    masters[n].add_(upd, alpha=-lr * scale[group])
                    if named[n].dtype != torch.float32:
                        named[n].data.copy_(masters[n])
    delta = {k: float((m - start[k]).norm()) for k, m in masters.items()}
    return {"losses": losses, "grad1": grad1, "grad1_tensors": grad1_t, "delta": delta}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms, |prog - ref| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or keep[n]]
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def moved(grad1: Dict[str, float]) -> Dict[str, bool]:
    """Leaves whose first gradient is above a thousandth of the median
    leaf's (the others move under Adam by round-off alone)."""
    med = float(np.median(list(grad1.values())))
    return {n: g > 1e-3 * med for n, g in grad1.items()}


def leaf_dists(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               ref_norms: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's norm of the difference, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median(list(ref_norms.values())))
    return {n: float((prog[n].to(torch.float32) - ref[n]).norm()) / max(ref_norms[n], med, 1e-30)
            for n in ref}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each step's loss (the worst step's relative gap), the first
    gradient and the change over the steps (the worst leaf's gap of
    norms, and the median leaf's; the change over the leaves the
    reference moves); where both sides kept the first gradient's tensors,
    its worst and median leaf's distance (``grad_dist``,
    ``grad_dist_med``); ``update_larger``, the share of the moved leaves
    whose change is the larger on the side."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    g = leaf_gaps(prog["grad1"], ref["grad1"])
    keep = moved(ref["grad1"])
    u = leaf_gaps(prog["delta"], ref["delta"], keep)
    out = {"loss_gap": loss, "grad_gap": max(g.values()), "update_gap": max(u.values()),
           "grad_med": float(np.median(list(g.values()))),
           "update_med": float(np.median(list(u.values()))),
           "update_larger": float(np.mean([prog["delta"][n] > ref["delta"][n] for n in u]))}
    if prog.get("grad1_tensors") and ref.get("grad1_tensors"):
        d = leaf_dists(prog["grad1_tensors"], ref["grad1_tensors"], ref["grad1"])
        out.update(grad_dist=max(d.values()), grad_dist_med=float(np.median(list(d.values()))))
    return out
