"""The plain reference of UniVS inference: the model (backbone -> pixel
decoder -> decoder) and the VIS and VSS loops, frozen from the port's
model code and drivers with the kernels replaced by their plain laws
(``ops/plain.py``).  It runs in float32 with TF32 off, imports nothing
of the program, and is handed the same frames, class embeddings and
weights (a state_dict under the program's names) as the program.

The VIS loop (``vis_video``) is the driver's one clip / window /
emission schedule: the window encode when a clip needs one, the entity
clip step on an in-place pool, each due window copied before eviction,
and at the end the drain of the finally-valid entities to output-size
binary masks.  ``vss_clip`` is one clip of ``run_vss``: the clip's own
encode, the detection decode and the semantic label law, with the
per-pixel class evidence that the labels are the argmax of.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.config import UniVSConfig
from benchmark.reference.inference import memory_pool as mp
from benchmark.reference.inference.entity import EntityClipConfig, entity_clip_step
from benchmark.reference.models.backbones import build_backbone
from benchmark.reference.models.decoder import UniVSDecoder
from benchmark.reference.models.pixel_decoder import MSDeformAttnPixelDecoder


def strict_float32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class UniVSModel(nn.Module):
    """backbone -> pixel decoder -> decoder under the program's parameter
    names (``backbone``, ``pixel_decoder``, ``decoder``)."""

    def __init__(self, cfg: UniVSConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone)
        p, d = cfg.pixel_decoder, cfg.decoder
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            self.backbone.out_channels, hidden_dim=p.hidden_dim, mask_dim=p.mask_dim,
            num_layers=p.num_layers, num_heads=p.num_heads, num_points=p.num_points,
            ffn_dim=p.ffn_dim, transformer_in_features=p.transformer_in_features)
        self.decoder = UniVSDecoder(
            hidden_dim=d.hidden_dim, num_queries=d.num_queries, num_layers=d.num_layers,
            num_heads=d.num_heads, ffn_dim=d.ffn_dim, pre_norm=d.pre_norm, mask_dim=d.mask_dim,
            text_emb_dim=d.clip_cls_emb_dim, self_attn_mask_type=d.self_attn_mask_type,
            num_max_frames=d.num_max_frames, l4p_fusion=d.l4p_fusion,
            temporal_query_shuffle=d.temporal_query_shuffle, remat_heads=d.remat_heads)

    def encode(self, frames: torch.Tensor):
        """[n, H, W, 3] raw RGB (uint8 or float) -> (mask_features [n, H/4,
        W/4, C], the three levels coarse to fine), float32."""
        mean = torch.tensor(self.cfg.pixel_mean, dtype=torch.float32, device=frames.device)
        std = torch.tensor(self.cfg.pixel_std, dtype=torch.float32, device=frames.device)
        x = (frames.to(torch.float32) - mean) / std
        mask_features, _, _, ms = self.pixel_decoder(self.backbone(x))
        return mask_features, tuple(ms)


def build_reference(cfg: UniVSConfig, state: Dict[str, torch.Tensor], device,
                    compute: bool = False) -> UniVSModel:
    """The reference model in float32 on ``device`` with ``state`` loaded
    strictly (every key, every shape); with ``compute``, in the
    configuration's compute dtype instead, but for the leaves a module
    keeps in float32 (as the program holds them)."""
    with torch.device(device):
        model = UniVSModel(cfg)
    own = model.state_dict()
    if set(own) != set(state):
        raise KeyError(f"reference weights: missing {sorted(set(own) - set(state))[:5]}, "
                       f"unexpected {sorted(set(state) - set(own))[:5]}")
    model.load_state_dict({k: v.to(device=device, dtype=torch.float32) for k, v in state.items()})
    if compute and cfg.dtype == "bfloat16":
        for mod in model.modules():
            keep = getattr(mod, "keep_float32", ())
            for tensors in (mod._parameters, mod._buffers):
                for name, t in tensors.items():
                    if t is not None and t.is_floating_point() and name not in keep:
                        t.data = t.data.to(torch.bfloat16)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# VIS
# ---------------------------------------------------------------------------


def iter_clips(V: int, T: int, stride: int, window: int):
    """The driver's clip schedule: per clip ``i``, ``clip_idx``
    (tail-clamped), ``rel`` (window-relative), ``offset`` (i - frames
    emitted), ``new_window`` (start of a fresh encode, else None),
    ``emits`` [(start, n_out)] and ``is_last``."""
    out_window = max(window - T, T)
    window_range = (0, 0)
    emitted_total = 0
    i, is_last = 0, False
    while i < V and not is_last:
        is_last = i + T >= V
        clip_idx = np.minimum(np.arange(i, i + T), V - 1)
        new_window = None
        if min(i + T, V) > window_range[1]:
            new_window = i
            window_range = (i, i + window)
        offset = i - emitted_total
        emits = []
        while (i + T - emitted_total) >= (out_window + T) or (is_last and emitted_total < V):
            n_out = out_window if not is_last else min(V - emitted_total, out_window + T)
            emits.append((emitted_total, n_out))
            emitted_total += n_out
            if is_last and emitted_total >= V:
                break
        yield {"i": i, "clip_idx": clip_idx, "rel": clip_idx - window_range[0],
               "offset": offset, "new_window": new_window, "emits": emits, "is_last": is_last}
        i += stride


def _upsample_threshold(logits: torch.Tensor, image_size, out_size, padded_size) -> torch.Tensor:
    """[E, n, h4, w4] logits -> [E, n, out_h, out_w] bool: bilinear to the
    padded size, crop, optional resize, threshold at 0."""
    y = F.interpolate(logits.to(torch.float32), size=tuple(padded_size), mode="bilinear",
                      align_corners=False)
    y = y[:, :, : image_size[0], : image_size[1]]
    if tuple(image_size) != tuple(out_size):
        y = F.interpolate(y, size=tuple(out_size), mode="bilinear", align_corners=False)
    return y > 0


@torch.no_grad()
def vis_video(model: UniVSModel, frames: torch.Tensor, cls_emb: torch.Tensor, capacity: int,
              encode: Optional[Callable] = None) -> Dict:
    """One video's VIS: frames [V, H, W, 3] on the device, cls_emb [K, Dt];
    ``encode(start, frame_idx)`` may serve the window encodes (default
    ``model.encode(frames[frame_idx])``).  Returns the final ``valid`` [E]
    and, per valid slot, the output-size binary masks [V, H, W] (numpy
    bool)."""
    cfg = model.cfg
    inf = cfg.inference
    T, stride, window = inf.num_frames, inf.clip_stride, inf.num_frames_window
    out_window = max(window - T, T)
    V, H, W = frames.shape[:3]
    dev = frames.device
    K = int(cls_emb.shape[0])
    cc = EntityClipConfig(
        num_queries=cfg.decoder.num_queries, topk_candidates=inf.topk_per_video,
        num_prev_frames_memory=cfg.prompt.num_prev_frames_memory,
        apply_cls_thres=inf.apply_cls_thres, newly_thres=inf.newly_entity_thres,
        consistency_thres=inf.consistency_thres[0], nms_thres=inf.nms_thres,
        num_dense_points=cfg.prompt.num_dense_points_test, clip_stride=stride, num_frames=T,
        detect_newly_interval_frames=inf.detect_newly_interval_frames)
    pool = mp.create_entity_memory(
        capacity, K, cfg.decoder.hidden_dim, (H // 4, W // 4), window=out_window + T,
        num_prompt_points=cc.num_dense_points, embd_history=8, prompt_history=T + stride,
        device=dev)
    modules = (model.pixel_decoder, model.decoder)
    if encode is None:
        encode = lambda _start, idx: model.encode(frames[idx])  # noqa: E731
    emitted: List[torch.Tensor] = []
    starts: List[int] = []
    feats = None
    for c in iter_clips(V, T, stride, window):
        if c["new_window"] is not None:
            idx = torch.as_tensor(np.minimum(np.arange(c["new_window"], c["new_window"] + window),
                                             V - 1), device=dev)
            feats = encode(c["new_window"], idx)
        rel = torch.as_tensor(c["rel"], device=dev)
        clip_feats = (feats[0][rel], tuple(m[rel] for m in feats[1]))
        entity_clip_step(modules, clip_feats, pool, c["clip_idx"], c["offset"], c["i"] == 0,
                         cls_emb, cc)
        for start, n_out in c["emits"]:
            win = pool.mask_logits[:, :n_out] / pool.occurrence[:, :n_out].clamp(min=1.0)[
                :, :, None, None]
            emitted.append(win.clone())
            starts.append(start)
            mp.evict_window(pool, n_out)
        if not c["is_last"]:
            mp.shift_clip(pool, stride)
    valid = pool.valid.cpu().numpy()
    masks = {}
    for e in np.flatnonzero(valid):
        m = np.zeros((V, H, W), bool)
        for win, start in zip(emitted, starts):
            up = _upsample_threshold(win[int(e)][None], (H, W), (H, W), (H, W))[0].cpu().numpy()
            n = min(up.shape[0], V - start)
            m[start:start + n] = up[:n]
        masks[int(e)] = m
    return {"valid": valid, "masks": masks}


# ---------------------------------------------------------------------------
# VSS
# ---------------------------------------------------------------------------


def vss_evidence(pred_logits: torch.Tensor, pred_masks: torch.Tensor, padded_hw,
                 image_hw) -> torch.Tensor:
    """The semantic label law of one clip: pred_logits [Q, K], pred_masks
    [Q, Tc, h4, w4] -> the per-pixel class evidence [Tc, K, ih, iw]
    (quality = count(> 1) / count(> -1) per query over the clip; evidence
    = sum_q sigmoid(logit) * quality * sigmoid(upsampled mask)); the labels
    are its argmax over K."""
    ih, iw = image_hw
    logits = torch.sigmoid(pred_logits.to(torch.float32))
    masks_t = pred_masks.to(torch.float32).transpose(0, 1)
    Q = logits.shape[0]

    def up_frame(mt):
        u = F.interpolate(mt[None], size=tuple(padded_hw), mode="bilinear", align_corners=False)
        return u[0, :, :ih, :iw]

    pos = torch.zeros((Q,), dtype=torch.int64, device=logits.device)
    tot = torch.zeros_like(pos)
    for mt in masks_t:
        u = up_frame(mt)
        pos += (u > 1).sum(dim=(1, 2))
        tot += (u > -1).sum(dim=(1, 2))
    quality = pos.to(torch.float32) / tot.clamp(min=1).to(torch.float32)
    wlogits = logits * quality[:, None]
    return torch.stack([torch.einsum("qc,qhw->chw", wlogits, torch.sigmoid(up_frame(mt)))
                        for mt in masks_t])


@torch.no_grad()
def vss_clip(model: UniVSModel, frames: torch.Tensor, frame_idx, cls_emb: torch.Tensor) -> Dict:
    """One VSS clip: frames [Tc, H, W, 3] on the device, ``frame_idx``
    their absolute indices -> the decoder's outputs and the evidence."""
    mf, ms = model.encode(frames)
    fi = torch.as_tensor(np.asarray(frame_idx), device=frames.device)[None]
    out = model.decoder(ms, mf, fi, task="detection", cls_emb=cls_emb)
    H, W = frames.shape[1:3]
    return {"pred_logits": out["pred_logits"][0], "pred_masks": out["pred_masks"][0],
            "evidence": vss_evidence(out["pred_logits"][0], out["pred_masks"][0], (H, W), (H, W))}
