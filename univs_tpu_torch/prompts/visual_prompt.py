"""Visual prompt encoding, mask prompts (counterpart of
``univs_tpu/prompts/visual_prompt.py:sample_visual_prompts`` on its
mask-prompt path and mask-only fast path — what the memory-pool
re-encode uses at inference).

Reference-exact semantics: mask prompts take the in-mask pixels of the
nearest-downsampled mask thresholded at ``min(0.5, global max)``
(prompt_encoder.py:221), in raster order, cyclically repeated to R
points when fewer than R pixels exist (prompt_encoder.py:478-479);
instances empty at the key frame give all-zero sets.  Point and box
prompts (training) are not ported in this slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


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


def sample_visual_prompts(img_feats_key: torch.Tensor, img_pos_key: torch.Tensor,
                          masks_key: torch.Tensor, occur_key: torch.Tensor, num_points: int,
                          mask_thresh: float = 0.5) -> PromptSample:
    """One key frame's mask prompts -> R-point prompt sets.

    img_feats_key / img_pos_key [H, W, C] (1/8 src incl. level embed and
    its PE); masks_key [Qp, Hm, Wm] in [0, 1]; occur_key [Qp] bool."""
    H, W, C = img_feats_key.shape
    Qp = masks_key.shape[0]
    R = num_points
    HW = H * W
    feats_flat = img_feats_key.reshape(HW, C)
    pos_flat = img_pos_key.reshape(HW, C)
    fm_flat = _resize_nearest_mask(masks_key.to(torch.float32), H, W).reshape(Qp, HW)
    # GLOBAL threshold min(0.5, max over all instances and pixels)
    thr = fm_flat.max().clamp(max=mask_thresh).clamp(min=1e-6)
    mask_binary = (fm_flat >= thr) & (fm_flat > 0)
    u = (HW - torch.arange(HW, dtype=torch.float32, device=fm_flat.device))[None] / HW
    mask_idx, n_mask = _cyclic_dense_select(mask_binary.to(torch.float32) * u, R)
    valid = occur_key & (n_mask > 0)
    kv_valid = valid[:, None].expand(Qp, R)
    keep = kv_valid[..., None].to(feats_flat.dtype)
    return PromptSample(kv=feats_flat[mask_idx] * keep, kv_pe=pos_flat[mask_idx] * keep,
                        kv_valid=kv_valid, valid=valid)
