"""Mask / box tensor utilities on the entity path (counterpart of
``univs_tpu/ops/mask_ops.py``).  Static shapes; empty or invalid masks
are handled by validity masking, as in the JAX package."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """Binary masks [..., H, W] -> xyxy boxes [..., 4] (0-valued if empty)."""
    H, W = masks.shape[-2:]
    m = masks > 0.5 if masks.dtype != torch.bool else masks
    any_mask = m.flatten(-2).any(-1)
    dev = masks.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    big = 1e8
    x_proj = m.any(dim=-2)  # [..., W]
    y_proj = m.any(dim=-1)  # [..., H]
    x0 = torch.where(x_proj, xs, big).amin(-1)
    x1 = torch.where(x_proj, xs + 1.0, -big).amax(-1)
    y0 = torch.where(y_proj, ys, big).amin(-1)
    y1 = torch.where(y_proj, ys + 1.0, -big).amax(-1)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1)
    return torch.where(any_mask[..., None], boxes, torch.zeros_like(boxes))


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU over the last two axes: a [..., N, 4], b [..., M, 4]
    -> [..., N, M] (xyxy)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-6)


def mask_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise mask IoU: a [N, *S], b [M, *S] (thresholded at 0.5) -> [N, M]."""
    af = (a > 0.5).reshape(a.shape[0], -1).to(torch.float32)
    bf = (b > 0.5).reshape(b.shape[0], -1).to(torch.float32)
    inter = af @ bf.T
    union = af.sum(-1)[:, None] + bf.sum(-1)[None, :] - inter
    return inter / union.clamp(min=1.0)


def pairwise_mask_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binary masks [N, H, W] x [M, H, W] -> IoU [N, M]."""
    af = a.reshape(a.shape[0], -1).to(torch.float32)
    bf = b.reshape(b.shape[0], -1).to(torch.float32)
    inter = af @ bf.T
    union = af.sum(-1)[:, None] + bf.sum(-1)[None, :] - inter
    return inter / union.clamp(min=1.0)


def nms_triu_keep_from_iou(iou: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference entity-dedup law (NOT greedy NMS): sort by score,
    drop any candidate whose IoU against ANY higher-scored candidate
    exceeds the threshold — suppressed candidates still suppress others
    (``torch.triu(max_biou, diagonal=1).max(0)``,
    inference_video_entity.py:556-559)."""
    N = iou.shape[0]
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=iou.device)
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-s, stable=True)  # ties keep original index order
    iou_s = iou[order][:, order]
    v = valid[order]
    upper = torch.triu(torch.ones((N, N), dtype=torch.bool, device=iou.device), diagonal=1)
    neg = torch.full_like(iou_s, float("-inf"))
    max_from_higher = torch.where(upper & v[:, None], iou_s, neg).amax(0)
    keep_sorted = v & (max_from_higher < iou_thres)
    return keep_sorted[torch.argsort(order, stable=True)]


def point_sample(feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at normalized coords (align_corners=False, zero
    padding).  feats [C, H, W]; coords [P, 2] in [0, 1] (x, y) -> [P, C]."""
    grid = (coords.to(feats.dtype) * 2.0 - 1.0)[None, None]  # [1, 1, P, 2]
    out = F.grid_sample(feats[None], grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)  # [1, C, 1, P]
    return out[0, :, 0].T


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize on the last two axes (align_corners=False, no
    antialias), as ``jax.image.resize(..., antialias=False)``."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(out_hw):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, H, W), size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, *out_hw)
