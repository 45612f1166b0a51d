"""Visual prompt encoding: point / box / mask annotations -> prompt
feature sets on the 1/8 feature grid (counterpart of
``univs_tpu/prompts/visual_prompt.py``).

Reference-exact semantics: mask prompts take the in-mask pixels of the
nearest-downsampled mask thresholded at ``min(0.5, global max)``
(prompt_encoder.py:221), in raster order at inference, cyclically
repeated to R points when fewer than R pixels exist
(prompt_encoder.py:478-479); instances empty at the key frame give
all-zero sets.  The memory-pool re-encode takes the mask-only path.

Training (``sample_train_clip_prompts``) draws a random key frame and a
prompt type per object (25 % point, 25 % box, 50 % mask —
prompt_encoder.py:679-695), jitters large boxes and orders the dense
points by a random priority.  Its draws come from
``draw_train_clip_prompts`` at the JAX package's key addresses and enter
the law as arguments.  All functions take ONE video.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from univs_tpu_torch.ops.mask_ops import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh


class PromptSample(NamedTuple):
    kv: torch.Tensor  # [Qp, R, C]
    kv_pe: torch.Tensor  # [Qp, R, C]
    kv_valid: torch.Tensor  # [Qp, R] bool
    valid: torch.Tensor  # [Qp] bool


def _resize_nearest_mask(masks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[Q, Hm, Wm] -> [Q, h, w] nearest-downsample with JAX's half-pixel
    centres, src = floor((dst + 0.5) * Hm / h).  For integer ratios this
    is plain strided subsampling (also torch's floor rule there); other
    ratios must not go through ``F.interpolate(mode='nearest')``, whose
    floor(dst * scale) picks other pixels."""
    q, hm, wm = masks.shape
    if hm % h == 0 and wm % w == 0:
        return masks[:, :: hm // h, :: wm // w][:, :h, :w]
    dev = masks.device
    iy = torch.floor((torch.arange(h, device=dev, dtype=torch.float64) + 0.5) * (hm / h)).long().clamp(max=hm - 1)
    ix = torch.floor((torch.arange(w, device=dev, dtype=torch.float64) + 0.5) * (wm / w)).long().clamp(max=wm - 1)
    return masks[:, iy][:, :, ix]


def _cyclic_dense_select(priority: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selectable pixels (priority > 0) in descending priority (ties in
    index order, as ``lax.top_k``), cyclically repeated to fill R slots.
    priority [Q, HW] -> (idx [Q, R], n_selectable [Q])."""
    hw = priority.shape[-1]
    k = min(r, hw)
    idx = torch.sort(priority, dim=1, descending=True, stable=True).indices[:, :k]
    if k < r:
        idx = torch.cat([idx, idx[:, : r - k]], dim=1)[:, :r]
    n = (priority > 0).sum(-1)
    j = torch.arange(r, device=priority.device)[None] % torch.clamp(torch.clamp(n, max=k), min=1)[:, None]
    return torch.gather(idx, 1, j), n


def _grid_coords(h: int, w: int, device) -> torch.Tensor:
    """Pixel-centre normalized (x, y) coords [H, W, 2]."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _box_grid_mask(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalized xyxy boxes [Q, 4] -> binary grid masks [Q, H, W]: integer
    grid coords against floor(x1 * w), ceil(x2 * w), strict > on the min
    edge (the reference's ``convert_box_to_mask``, univs/utils/comm.py:6-38)."""
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
    b = boxes.to(torch.float32) * scale
    x1, y1 = torch.floor(b[:, 0]), torch.floor(b[:, 1])
    x2, y2 = torch.ceil(b[:, 2]), torch.ceil(b[:, 3])
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=boxes.device),
                            torch.arange(w, dtype=torch.float32, device=boxes.device),
                            indexing="ij")
    return ((gx[None] > x1[:, None, None]) & (gx[None] <= x2[:, None, None])
            & (gy[None] > y1[:, None, None]) & (gy[None] <= y2[:, None, None]))


class TrainPromptDraw(NamedTuple):
    """The draws of one video's training prompt sample."""

    key_fid: int  # key frame
    type_u: torch.Tensor  # [Qp] prompt type: <= 0.25 point, <= 0.5 box, else mask
    jitter_wh: torch.Tensor  # [Qp, 2] box size jitter in [0, 1)
    jitter_c: torch.Tensor  # [Qp, 2] box centre jitter in [0, 1)
    priority: torch.Tensor  # [Qp, HW] dense-point priority in [0.1, 1)


def draw_train_clip_prompts(key, T: int, Qp: int, HW: int) -> TrainPromptDraw:
    """One video's draws at the JAX package's addresses
    (``sample_train_clip_prompts`` then ``sample_visual_prompts(train=True)``,
    ``univs_tpu/prompts/visual_prompt.py:151-166,256-259``)."""
    r_key, r_type, r_sample = key.split(3)
    r1, r2, rest = r_sample.split(3)
    rk, _ = rest.split(2)
    return TrainPromptDraw(key_fid=r_key.randint(0, T), type_u=r_type.uniform((Qp,)),
                           jitter_wh=r1.uniform((Qp, 2)), jitter_c=r2.uniform((Qp, 2)),
                           priority=rk.uniform((Qp, HW), 0.1, 1.0))


def sample_visual_prompts(img_feats_key: torch.Tensor, img_pos_key: torch.Tensor,
                          masks_key: torch.Tensor, occur_key: torch.Tensor, num_points: int,
                          mask_thresh: float = 0.5, boxes_key: Optional[torch.Tensor] = None,
                          prompt_flags: Optional[torch.Tensor] = None,
                          draw: Optional[TrainPromptDraw] = None) -> PromptSample:
    """One key frame's prompts -> R-point prompt sets.

    img_feats_key / img_pos_key [H, W, C] (1/8 src incl. level embed and
    its PE); masks_key [Qp, Hm, Wm] in [0, 1]; occur_key [Qp] bool.
    Without ``prompt_flags`` every prompt is a mask (the pool re-encode's
    fast path, JAX's ``mask_only``); with them ([Qp] int: 0 point, 1 box,
    2 mask) ``boxes_key`` [Qp, 4] normalized xyxy is needed, and ``draw``
    (training) jitters boxes and randomizes the dense-point order."""
    H, W, C = img_feats_key.shape
    Qp = masks_key.shape[0]
    R = num_points
    HW = H * W
    dev = img_feats_key.device
    feats_flat = img_feats_key.reshape(HW, C)
    pos_flat = img_pos_key.reshape(HW, C)
    fm_flat = _resize_nearest_mask(masks_key.to(torch.float32), H, W).reshape(Qp, HW)
    # GLOBAL threshold min(0.5, max over all instances and pixels)
    thr = fm_flat.max().clamp(max=mask_thresh).clamp(min=1e-6)
    mask_binary = (fm_flat >= thr) & (fm_flat > 0)
    if draw is None:  # raster order (the reference's torch.nonzero order)
        u = (HW - torch.arange(HW, dtype=torch.float32, device=dev))[None] / HW
    else:  # random order (the reference's randperm)
        u = draw.priority.to(dev)
    mask_idx, n_mask = _cyclic_dense_select(mask_binary.to(torch.float32) * u, R)
    if prompt_flags is None:
        valid = occur_key & (n_mask > 0)
        kv_valid = valid[:, None].expand(Qp, R)
        keep = kv_valid[..., None].to(feats_flat.dtype)
        return PromptSample(kv=feats_flat[mask_idx] * keep, kv_pe=pos_flat[mask_idx] * keep,
                            kv_valid=kv_valid, valid=valid)

    boxes_key = boxes_key.to(torch.float32)
    boxes = boxes_key
    if draw is not None:  # box jitter of large boxes (prompt_encoder.py:307-326)
        cxcywh = box_xyxy_to_cxcywh(boxes_key)
        wh = cxcywh[:, 2:]
        noise_wh = (wh + 0.1 * wh * (2 * draw.jitter_wh.to(dev) - 1)).clamp(0, 1)
        noise_c = (cxcywh[:, :2] + 0.1 * wh * (2 * draw.jitter_c.to(dev) - 1)).clamp(0, 1)
        big = (wh[:, 0] * wh[:, 1] > 0.09)[:, None]
        boxes = torch.where(big, box_cxcywh_to_xyxy(torch.cat([noise_c, noise_wh], -1)),
                            boxes_key)
    box_binary = _box_grid_mask(boxes, H, W).reshape(Qp, HW)
    box_idx, n_box = _cyclic_dense_select(box_binary.to(torch.float32) * u, R)

    # point prompt: the in-mask point of largest (centre-biased) priority,
    # its feature repeated R times
    coords = _grid_coords(H, W, dev).reshape(HW, 2)
    cxcywh = box_xyxy_to_cxcywh(boxes_key)
    ctr_dist = (coords[None] - cxcywh[:, None, :2]).abs()
    in_ctr = (ctr_dist < 0.25 * cxcywh[:, None, 2:].clamp(min=1e-6)).all(-1)
    point_priority = mask_binary.to(torch.float32) * u * (1.0 + in_ctr.to(torch.float32))
    point_idx = torch.argmax(point_priority, dim=1)
    point_valid = torch.gather(point_priority, 1, point_idx[:, None])[:, 0] > 0

    flags = prompt_flags.to(dev)[:, None, None]
    pt_kv = feats_flat[point_idx][:, None].expand(Qp, R, C)
    pt_pe = pos_flat[point_idx][:, None].expand(Qp, R, C)
    kv = torch.where(flags == 0, pt_kv, torch.where(flags == 1, feats_flat[box_idx],
                                                    feats_flat[mask_idx]))
    kv_pe = torch.where(flags == 0, pt_pe, torch.where(flags == 1, pos_flat[box_idx],
                                                       pos_flat[mask_idx]))
    pf = prompt_flags.to(dev)
    valid = occur_key & torch.where(pf == 0, point_valid,
                                    torch.where(pf == 1, n_box > 0, n_mask > 0))
    kv_valid = valid[:, None].expand(Qp, R)
    keep = kv_valid[..., None].to(kv.dtype)
    return PromptSample(kv=kv * keep, kv_pe=kv_pe * keep, kv_valid=kv_valid, valid=valid)


def sample_train_clip_prompts(img_feats: torch.Tensor, img_pos: torch.Tensor,
                              masks: torch.Tensor, boxes: torch.Tensor, occur: torch.Tensor,
                              obj_valid: torch.Tensor, num_points: int,
                              draw: TrainPromptDraw) -> Tuple[PromptSample, int]:
    """Training-time sample of one clip: the drawn key frame's
    annotations drive all T frames.  img_feats / img_pos [T, H, W, C];
    masks [Qp, T, Hm, Wm]; boxes [Qp, T, 4] normalized; occur [Qp, T];
    obj_valid [Qp].  Returns (the key frame's PromptSample, key frame)."""
    k = draw.key_fid
    u = draw.type_u.to(img_feats.device)
    flags = torch.where(u <= 0.25, 0, torch.where(u <= 0.5, 1, 2))
    sample = sample_visual_prompts(img_feats[k], img_pos[k], masks[:, k], occur[:, k] & obj_valid,
                                   num_points, boxes_key=boxes[:, k], prompt_flags=flags,
                                   draw=draw)
    return sample, k


def broadcast_prompt_sample(sample: PromptSample, t: int):
    """[Qp, R, C] key-frame sets -> a SINGLETON frame axis [Qp, R, 1, C]:
    the decoder's ProCA folds frames into the query axis for
    frame-invariant kv, so the T-fold broadcast is not materialized
    (``t`` kept for the JAX package's signature)."""
    del t
    return sample.kv[:, :, None], sample.kv_pe[:, :, None], sample.kv_valid[:, :, None]
