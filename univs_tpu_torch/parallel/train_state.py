"""Training state and the train step (counterpart of
``univs_tpu/parallel/train_state.py``): one process, or one a card under
data parallelism (``parallel/ddp.py``).

Mixed precision the way the JAX package does it: JAX keeps float32
params and casts them to the compute dtype at use, so a parameter's
gradient is the compute-dtype gradient of its cast, upcast.  Here the
working model is the compute-dtype model ``_place`` builds (its
``keep_float32`` parameters stay float32), the ``TrainState`` holds the
float32 masters, and a step upcasts the working gradients, updates the
masters and copies them back with rounding.

The optimizer is ``make_optimizer``'s, per label group ('backbone' at
``backbone_lr_multiplier``, 'rest'): clip by the GROUP's global norm
(optax.multi_transform wraps ``clip_by_global_norm`` per group) -> Adam
(b1 0.9, b2 0.999, eps 1e-8 added to sqrt(v_hat)) -> decoupled weight
decay under the decay mask -> x schedule(count), count 0 at the first
update -> x -lr_scale.  Labels and the decay mask are decided on the
JAX param paths (``utils.weights.flax_leaf_of``).  The EMA of the
masters follows every step.

The JAX package trains the frozen-BN parameters (``FrozenBatchNorm``
declares scale, bias, mean and var as plain params with no
stop_gradient): ``create_train_state`` makes the port's trainable too
(``running_mean`` / ``running_var`` become parameters), so inference
builds keep their buffers.

BoxVIS (``train.boxvis_enabled``) trains the box-projection loss; with
``boxvis_ema_enabled`` an EMA teacher, a compute-dtype copy of the
working model that takes the EMA masters before each update, runs a
no-grad forward on the batch and its pseudo masks supervise the
learnable queries (JAX ``train_state.py:225-246``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from univs_tpu_torch.config import UniVSConfig
from univs_tpu_torch.losses.criterion import (TrainTargets, UniCriterion,
                                              boxvis_teacher_pseudo_masks)
from univs_tpu_torch.ops.mask_ops import masks_to_boxes
from univs_tpu_torch.parallel.ddp import BatchShard
from univs_tpu_torch.structures import TextPrompts
from univs_tpu_torch.utils.weights import flax_leaf_of

B1, B2, EPS = 0.9, 0.999, 1e-8
EMBED_NAMES = ("query_feat", "query_embed", "level_embed", "cls_temp", "reid_temp",
               "prompt_detection", "prompt_sot", "prompt_grounding")


@dataclass
class TrainBatch:
    """One training batch (leading axis = videos).  Detection: the prompt
    queries are the targets' category embeddings padded with negative
    categories to Qp slots, ``targets.prompt_obj_ids`` binds each slot to
    its target (-1 negative / padding); ``category_bank`` is the
    classification head's class slice.  Grounding: per-expression
    [sentence; words] features."""

    images: torch.Tensor  # [B, T, H, W, 3]
    frame_indices: torch.Tensor  # [B, T]
    targets: TrainTargets
    prompt_category_embs: Optional[torch.Tensor] = None  # [B, Qp, Dt]
    prompt_category_valid: Optional[torch.Tensor] = None  # [B, Qp]
    category_bank: Optional[torch.Tensor] = None  # [K, Dt]
    category_bank_valid: Optional[torch.Tensor] = None  # [K]
    exp_embs: Optional[torch.Tensor] = None  # [B, Qp, 1+L, Dt]
    exp_valid: Optional[torch.Tensor] = None  # [B, Qp]

    def to(self, device) -> "TrainBatch":
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return TrainBatch(**{k: (None if v is None else v.to(device)) for k, v in out.items()})


@dataclass
class TrainState:
    """step; float32 masters, Adam moments and EMA keyed by the model's
    state_dict names (trainable parameters only)."""

    step: int
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# labels, decay mask, schedule
# ---------------------------------------------------------------------------


def param_label(path) -> str:
    """'backbone' vs 'rest' on the JAX path (train_net.py:211-292)."""
    return "backbone" if path[:1] == ("backbone",) else "rest"


def decays(path, ndim: int) -> bool:
    """The JAX decay mask on a flax path: no decay for norms (a key of
    the last two containing 'norm', or a scale / bias / mean / var leaf),
    the embedding tables, and every leaf of rank <= 1."""
    is_norm = any("norm" in k.lower() or k in ("scale", "bias", "mean", "var") for k in path[-2:])
    is_embed = any(k in EMBED_NAMES for k in path)
    return not (is_norm or is_embed or ndim <= 1)


def lr_schedule(c) -> Callable[[int], float]:
    """The reference's ``build_lr_scheduler`` families (the JAX package's
    ``_lr_schedule``): 'multistep' (linear warmup from warmup_factor,
    x lr_gamma at each of lr_steps), 'poly' (lr (1 - it / max_iter) ^
    poly_power after the warmup factor), 'cosine' (linear warmup from 0,
    then cosine decay to lr / 100 at max_iter).  In float32."""
    f32 = np.float32
    if c.lr_scheduler == "cosine":
        warm, total = c.warmup_iters, c.max_iter
        alpha = 0.0 if c.lr == 0.0 else (c.lr * 0.01) / c.lr

        def cosine(step):
            if step < warm:
                frac = 1.0 - min(max(step, 0), warm) / warm
                return float(f32(-c.lr * frac + c.lr))
            count = min(float(step - warm), float(total - warm))
            decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / (total - warm))) + alpha
            return float(f32(c.lr * f32(decayed)))
        return cosine

    def warmup(step):
        if c.warmup_iters <= 0 or c.warmup_factor >= 1.0:
            return f32(1.0)
        a = f32(min(max(step / c.warmup_iters, 0.0), 1.0))
        return f32(c.warmup_factor * (1.0 - a) + a)

    if c.lr_scheduler == "poly":
        def poly(step):
            frac = f32(min(max(1.0 - step / max(c.max_iter, 1), 0.0), 1.0))
            return float(f32(c.lr) * warmup(step) * f32(frac ** c.poly_power))
        return poly

    assert c.lr_scheduler == "multistep", c.lr_scheduler

    def multistep(step):
        n = sum(step >= b for b in sorted(c.lr_steps))
        return float(f32(c.lr) * warmup(step) * f32(c.lr_gamma ** n))
    return multistep


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def _promote_frozen_bn(model: nn.Module) -> None:
    """Make every FrozenBatchNorm's four tensors trainable parameters."""
    from univs_tpu_torch.models.backbones.resnet import FrozenBatchNorm

    for mod in model.modules():
        if isinstance(mod, FrozenBatchNorm):
            for name in ("running_mean", "running_var"):
                if name in mod._buffers:
                    t = mod._buffers.pop(name)
                    mod.register_parameter(name, nn.Parameter(t))


def trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    return dict(model.named_parameters())


def create_train_state(cfg: UniVSConfig, model: nn.Module, params=None) -> TrainState:
    """Make ``model`` (a placed working model) trainable and return the
    state: float32 masters from ``params`` (a float32 state_dict, e.g.
    from ``state_dict_from_flax``) or, when None, the model's values
    upcast; zero moments; the EMA a copy of the masters."""
    _promote_frozen_bn(model)
    model.train()
    named = trainable(model)
    for p in named.values():
        p.requires_grad_(True)
    masters = {}
    for k, p in named.items():
        src = p.detach() if params is None else torch.as_tensor(np.array(params[k]))
        masters[k] = src.to(device=p.device, dtype=torch.float32).clone()
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(masters[k])
    return TrainState(step=0, params=masters,
                      mu={k: torch.zeros_like(v) for k, v in masters.items()},
                      nu={k: torch.zeros_like(v) for k, v in masters.items()},
                      ema_params={k: v.clone() for k, v in masters.items()})


def param_groups(model: nn.Module) -> Tuple[Dict[str, str], Dict[str, bool]]:
    """(label per parameter name, decay flag per parameter name), decided
    on the JAX path each one comes from."""
    labels, decay = {}, {}
    for k in trainable(model):
        leaves = flax_leaf_of(model, k)
        labels[k] = param_label(leaves[0][0])
        decay[k] = all(decays(path, nd) for path, nd in leaves)
    return labels, decay


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def boxes_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """[B, N, T, H, W] -> normalized xyxy [B, N, T, 4]."""
    H, W = masks.shape[-2:]
    scale = torch.tensor([W, H, W, H], dtype=torch.float32, device=masks.device)
    return masks_to_boxes(masks) / scale


def _model_inputs(cfg: UniVSConfig, batch: TrainBatch, task: str):
    """(model kwargs, class-column validity, level sizes, tokens per prompt,
    targets) of one task, as the JAX ``loss_fn`` builds them."""
    targets = batch.targets
    dev = batch.images.device
    level_sizes, tokens = None, 1
    if task == "detection":
        tp = TextPrompts(embs=batch.prompt_category_embs[:, :, None, :],
                         valid=batch.prompt_category_valid)
        kwargs = dict(text_prompts=tp, cls_emb=batch.category_bank)
        cls_valid = batch.category_bank_valid
    elif task == "grounding":
        kwargs = dict(text_prompts=TextPrompts(embs=batch.exp_embs, valid=batch.exp_valid))
        cls_valid = torch.ones((1,), dtype=torch.bool, device=dev)
        h, w = batch.images.shape[2:4]
        level_sizes = ((h // 32, w // 32), (h // 16, w // 16), (h // 8, w // 8))
        tokens = batch.exp_embs.shape[2]
    elif task == "sot":
        kwargs = dict(cls_emb=torch.zeros((1, cfg.decoder.clip_cls_emb_dim), device=dev),
                      gt_masks=targets.masks, gt_boxes=boxes_from_masks(targets.masks),
                      gt_occur=targets.ids >= 0, gt_obj_valid=targets.valid)
        cls_valid = torch.ones((1,), dtype=torch.bool, device=dev)
        # prompt slot i <- target slot i (GT-driven sampling keeps order)
        n = targets.valid.shape[1]
        poi = torch.where(targets.valid, torch.arange(n, device=dev)[None], -1)
        targets = dataclasses.replace(targets, prompt_obj_ids=poi)
    else:
        raise ValueError(f"task {task!r}: the trainer takes detection, grounding or sot")
    return kwargs, cls_valid, level_sizes, tokens, targets


def _group_grads(state: TrainState, names, named, shard: BatchShard) -> list:
    """One label group's working gradients upcast to float32 (none: zero);
    under data parallelism summed over the processes as one flat buffer,
    before the clip sees them (JAX's psum)."""
    grads = [torch.zeros_like(state.params[n]) if named[n].grad is None
             else named[n].grad.to(torch.float32) for n in names]
    if shard.distributed:
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=shard.group)
        grads = [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]
    return grads


def _adamw_group(state: TrainState, names, grads, decay, c, lr_scaled: float, bc1: float,
                 bc2: float) -> None:
    """One label group's update on the float32 masters, in place: the
    float32 gradients clipped by the group's global norm, Adam, decoupled
    decay where the mask says, x -lr_scaled."""
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(gnorm < c.clip_gradients_value, 1.0, c.clip_gradients_value / gnorm)
    torch._foreach_mul_(grads, factor)
    mu, nu = [state.mu[n] for n in names], [state.nu[n] for n in names]
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, EPS)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    masters = [state.params[n] for n in names]
    dec = [i for i, n in enumerate(names) if decay[n]]
    if dec:
        torch._foreach_add_([upd[i] for i in dec], [masters[i] for i in dec],
                            alpha=c.weight_decay)
    torch._foreach_add_(masters, upd, alpha=-lr_scaled)


def make_teacher(model: nn.Module) -> nn.Module:
    """BoxVIS's EMA teacher: a compute-dtype copy of the working model
    (its ``keep_float32`` parameters in float32, as ``_place`` builds it)
    that takes no gradient; the step copies the EMA masters into it."""
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return teacher.train()


EVENTS = ("forward_ms", "teacher_ms", "backward_ms", "allreduce_ms", "optimizer_ms")


def make_train_step(cfg: UniVSConfig, model: nn.Module, task: str = "detection",
                    timings: Optional[Dict[str, float]] = None, data_parallel: bool = False,
                    group=None):
    """The train step of one task family: ``step(state, batch, key) ->
    (state, logged)`` with ``key`` a ``DrawKey``; the state and the
    working model are updated in place.  ``logged`` holds every loss of
    the criterion and ``total_loss`` as tensors.  With ``timings`` (a
    dict) each step on the card adds the ms of its forward (the criterion
    included), the BoxVIS teacher's forward, the backward, the gradient
    all-reduce and the optimizer (CUDA events) under ``EVENTS``' names.
    ``data_parallel`` (``parallel/ddp.make_train_step``): ``batch`` is
    this process's shard of the global batch, in process group ``group``;
    the step is the one-process step's on the global batch."""
    if task not in ("detection", "grounding", "sot"):
        raise ValueError(f"task {task!r}: the trainer takes detection, grounding or sot")
    c = cfg.train
    criterion = UniCriterion(c, cfg.decoder.num_queries, cfg.num_frames)
    sched = lr_schedule(c)
    labels, decay = param_groups(model)
    scale = {"backbone": c.backbone_lr_multiplier, "rest": 1.0}
    named = trainable(model)
    teacher = make_teacher(model) if c.boxvis_enabled and c.boxvis_ema_enabled else None
    teacher_params = None if teacher is None else [dict(teacher.named_parameters())[n]
                                                   for n in named]

    def events():
        if timings is None or not next(iter(named.values())).is_cuda:
            return None
        return {k: torch.cuda.Event(enable_timing=True) for k in ("start", *EVENTS)}

    def step(state: TrainState, batch: TrainBatch, key):
        ev = events()
        k = key.fold_in(state.step)
        r_model, r_crit, r_shuffle, r_prompt = k.split(4)
        kwargs, cls_valid, level_sizes, tokens, targets = _model_inputs(cfg, batch, task)
        B = batch.images.shape[0]
        shard = (BatchShard.of(B, group, batch.images.device) if data_parallel
                 else BatchShard.whole(B))
        for p in named.values():
            p.grad = None
        if ev:
            ev["start"].record()
        pseudo = None
        if teacher is not None:
            # the EMA masters before this step's update; the teacher's
            # shuffle takes r_model, the split the student leaves unused
            with torch.no_grad():
                torch._foreach_copy_(teacher_params, [state.ema_params[n] for n in named])
                out_t = teacher(batch.images, batch.frame_indices, task=task, train=True,
                                shuffle_key=r_model, prompt_key=r_prompt, shard=shard, **kwargs)
                Ql = cfg.decoder.num_queries
                pseudo = boxvis_teacher_pseudo_masks(
                    r_crit.fold_in(31337), out_t["pred_logits"][:, :Ql],
                    out_t["pred_masks"][:, :Ql], targets, cls_valid, c, shard)
                del out_t
        if ev:
            ev["teacher_ms"].record()
        out = model(batch.images, batch.frame_indices, task=task, train=True,
                    shuffle_key=r_shuffle, prompt_key=r_prompt, shard=shard, **kwargs)
        total, logged = criterion(
            r_crit, out, targets, cls_valid, task=task, class_loss=(task != "sot"),
            sem_loss=(task == "detection"), level_sizes=level_sizes, tokens_per_prompt=tokens,
            boxvis=c.boxvis_enabled, pseudo=pseudo, shard=shard)
        if ev:
            ev["forward_ms"].record()
        total.backward()
        if ev:
            ev["backward_ms"].record()
        with torch.no_grad():
            groups = {}
            for group_name in ("backbone", "rest"):
                names = [n for n in named if labels[n] == group_name]
                if names:
                    groups[group_name] = (names, _group_grads(state, names, named, shard))
            if ev:
                ev["allreduce_ms"].record()
            lr = sched(state.step)  # the schedule's count and Adam's before this update
            bc1 = float(1 - np.float32(B1) ** np.float32(state.step + 1))
            bc2 = float(1 - np.float32(B2) ** np.float32(state.step + 1))
            for group_name, (names, grads) in groups.items():
                _adamw_group(state, names, grads, decay, c, lr * scale[group_name], bc1, bc2)
            params = [named[n] for n in named]
            torch._foreach_copy_(params, [state.params[n] for n in named])
            ema = [state.ema_params[n] for n in named]
            torch._foreach_mul_(ema, c.ema_decay)
            torch._foreach_add_(ema, [state.params[n] for n in named], alpha=1.0 - c.ema_decay)
        state.step += 1
        if ev:
            ev["optimizer_ms"].record()
            torch.cuda.synchronize()
            order = ("start", "teacher_ms", "forward_ms", "backward_ms", "allreduce_ms",
                     "optimizer_ms")
            for a, b in zip(order, order[1:]):
                timings[b] = timings.get(b, 0.0) + ev[a].elapsed_time(ev[b])
        logged = {k: v.detach() for k, v in logged.items()}
        logged["total_loss"] = total.detach()
        if shard.distributed:  # the global batch's losses on every process
            names = list(logged)
            summed = shard.count(torch.stack([logged[n].to(torch.float32) for n in names]))
            logged = dict(zip(names, summed.unbind()))
        return state, logged

    step.criterion = criterion
    step.teacher = teacher
    return step
