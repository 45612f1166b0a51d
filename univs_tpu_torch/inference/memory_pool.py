"""Fixed-capacity entity memory pool for clip-streaming inference
(counterpart of ``univs_tpu/inference/memory_pool.py``).

The same fields and shapes as the JAX pool.  The JAX package threads an
immutable pytree through donated jit calls; here ``EntityMemory`` is a
dataclass of tensors that the functions below update IN PLACE (that is
what donation buys on the TPU: no copy of the ~320 MB pool per call).
A caller that needs a field's value after a later update must clone it
first — the driver clones every emitted window before ``evict_window``
and ``shift_clip`` run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from univs_tpu_torch.losses.hungarian import hungarian


@dataclass
class EntityMemory:
    """State for up to E entities over a video.  Shapes: E slots, F_e
    embedding-history frames, W mask-window frames, R prompt points, F_p
    prompt-history frames, K classes, C hidden, (H4, W4) mask res."""

    valid: torch.Tensor  # [E] bool
    first_appear: torch.Tensor  # [E] int32 (-1 unset)
    logits_sum: torch.Tensor  # [E, K]
    logits_count: torch.Tensor  # [E]
    logits_last: torch.Tensor  # [E, K]
    embds: torch.Tensor  # [E, F_e, C]
    mask_logits: torch.Tensor  # [E, W, H4, W4]
    occurrence: torch.Tensor  # [E, W]
    quality_sum: torch.Tensor  # [E]
    prompt_feats: torch.Tensor  # [E, R, F_p, C]
    prompt_pe: torch.Tensor  # [E, R, F_p, C]
    prompt_valid: torch.Tensor  # [E, R, F_p] bool
    first_feats: torch.Tensor  # [E, R, C]
    first_pe: torch.Tensor  # [E, R, C]
    first_valid: torch.Tensor  # [E, R] bool
    window_start: int = 0  # absolute frame of mask_logits[:, 0]

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def create_entity_memory(capacity: int, num_classes: int, hidden_dim: int, mask_hw: Tuple[int, int],
                         window: int, num_prompt_points: int, embd_history: int = 8,
                         prompt_history: int = 6, dtype=torch.float32, device=None) -> EntityMemory:
    E, K, C = capacity, num_classes, hidden_dim
    H4, W4 = mask_hw
    R, Fp, Fe, W = num_prompt_points, prompt_history, embd_history, window

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    return EntityMemory(
        valid=torch.zeros(E, dtype=torch.bool, device=device),
        first_appear=torch.full((E,), -1, dtype=torch.int32, device=device),
        logits_sum=z(E, K), logits_count=z(E), logits_last=z(E, K),
        embds=z(E, Fe, C), mask_logits=z(E, W, H4, W4), occurrence=z(E, W), quality_sum=z(E),
        prompt_feats=z(E, R, Fp, C), prompt_pe=z(E, R, Fp, C),
        prompt_valid=torch.zeros((E, R, Fp), dtype=torch.bool, device=device),
        first_feats=z(E, R, C), first_pe=z(E, R, C),
        first_valid=torch.zeros((E, R), dtype=torch.bool, device=device),
    )


# ---------------------------------------------------------------------------
# ring-buffer shifts
# ---------------------------------------------------------------------------


def _shift_left_(x: torch.Tensor, dim: int, n: int) -> None:
    """In place: drop the first n entries along ``dim``, zero-fill the end."""
    size = x.shape[dim]
    x.narrow(dim, 0, size - n).copy_(x.narrow(dim, n, size - n).clone())
    x.narrow(dim, size - n, n).zero_()


def shift_clip(pool: EntityMemory, stride: int) -> EntityMemory:
    """Advance per-clip histories by one clip (stride frames), as the
    reference's zero/copy padding for the next clip
    (pad_zero_annotations_for_next_clip:878-912, zero_pad_prompt:1059)."""
    valid = pool.valid
    emb_pad = pool.embds[:, -3:].mean(dim=1, keepdim=True)
    shifted = torch.cat([pool.embds[:, 1:], emb_pad], dim=1)
    pool.embds.copy_(torch.where(valid[:, None, None], shifted, pool.embds))
    pool.logits_sum += pool.logits_last * valid[:, None]
    pool.logits_count += valid
    for x in (pool.prompt_feats, pool.prompt_pe, pool.prompt_valid):
        _shift_left_(x, 2, stride)
    return pool


def evict_window(pool: EntityMemory, out_frames: int) -> EntityMemory:
    """Drop the first ``out_frames`` frames of the mask window after
    emission (reference: inference_video_entity.py:394-397)."""
    _shift_left_(pool.mask_logits, 1, out_frames)
    _shift_left_(pool.occurrence, 1, out_frames)
    pool.window_start += out_frames
    return pool


# ---------------------------------------------------------------------------
# prompt kv read (decoder_univs.py:795-822)
# ---------------------------------------------------------------------------


def read_prompt_kv(pool: EntityMemory, num_prev: int):
    """First-appearance prompt set + last ``num_prev`` frames' sets ->
    ProCA kv [E, (1+num_prev)*R, C] (+pe, +valid), frame-major."""
    E, R, Fp, C = pool.prompt_feats.shape
    num_prev = min(num_prev, Fp)
    prev_f = pool.prompt_feats[:, :, -num_prev:].transpose(1, 2).reshape(E, num_prev * R, C)
    prev_p = pool.prompt_pe[:, :, -num_prev:].transpose(1, 2).reshape(E, num_prev * R, C)
    prev_v = pool.prompt_valid[:, :, -num_prev:].transpose(1, 2).reshape(E, num_prev * R)
    kv = torch.cat([pool.first_feats, prev_f], dim=1)
    kv_pe = torch.cat([pool.first_pe, prev_p], dim=1)
    kv_valid = torch.cat([pool.first_valid, prev_v], dim=1) & pool.valid[:, None]
    return kv, kv_pe, kv_valid


def read_clip_queries(pool: EntityMemory, t: int):
    """Per-frame prompt-query inits from the ring's last ``t`` slots:
    non-blank means over the R entries -> (queries, query_pos) [E, t, C]."""
    f = pool.prompt_feats[:, :, -t:]
    p = pool.prompt_pe[:, :, -t:]
    v = pool.prompt_valid[:, :, -t:]
    denom = v.sum(1).clamp(min=1)[..., None].to(f.dtype)
    m = v[..., None].to(f.dtype)
    return (f * m).sum(1) / denom, (p * m).sum(1) / denom


# ---------------------------------------------------------------------------
# tracked-entity update
# ---------------------------------------------------------------------------


def window_slice(x: torch.Tensor, clip_offset: int, t: int) -> torch.Tensor:
    """View of the ``t`` window frames a clip at ``clip_offset`` reads
    (dim 1), from the start ``jax.lax.dynamic_slice_in_dim`` takes: the
    offset clamped to [0, W - t]."""
    s = min(max(int(clip_offset), 0), x.shape[1] - t)
    return x[:, s:s + t]


def accumulate_clip_masks(pool: EntityMemory, clip_offset: int, masks: torch.Tensor,
                          embds_mean: torch.Tensor, update: torch.Tensor,
                          quality: torch.Tensor) -> EntityMemory:
    """Additive mask-logit accumulation + occurrence counting + embd
    averaging for gated entities (reference: inference_video_entity.py:493-515)."""
    T = masks.shape[1]
    nonblank = (masks > 0).flatten(2).any(-1).to(pool.occurrence.dtype)  # [E, T]
    win = window_slice(pool.mask_logits, clip_offset, T)
    win += torch.where(update[:, None, None, None], masks.to(win.dtype), 0.0)
    occ = window_slice(pool.occurrence, clip_offset, T)
    occ += torch.where(update[:, None], nonblank, 0.0)
    old = pool.embds[:, -1]
    nonblank_e = (old != 0).any(-1)
    new_e = (old + embds_mean) / (nonblank_e[:, None].to(old.dtype) + 1.0)
    pool.embds[:, -1] = torch.where(update[:, None], new_e, old)
    pool.quality_sum += torch.where(update, quality, 0.0)
    return pool


def consistency_gate(pool: EntityMemory, pred_embds: torch.Tensor, num_prev: int, threshold: float):
    """Cosine consistency vs the embd history with temporal weighting
    (reference: comm.py:64-95, :10-23) -> (is_consistent [E], sim [E])."""
    prev = pool.embds[:, -num_prev:]
    F = prev.shape[1]
    prev_n = prev / torch.linalg.norm(prev, dim=-1, keepdim=True).clamp(min=1e-3)
    cur_n = pred_embds / torch.linalg.norm(pred_embds, dim=-1, keepdim=True).clamp(min=1e-3)
    sim = (prev_n @ cur_n.to(prev_n.dtype).transpose(1, 2)).sum(-1) / pred_embds.shape[1]
    nonblank = (prev != 0).any(-1).to(torch.float32)
    w = torch.exp(torch.arange(1, F + 1, dtype=torch.float32, device=prev.device) / F * 5.0) * nonblank
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-3)
    sim = (sim * w).sum(-1)
    return (sim > threshold) & pool.valid, sim


# ---------------------------------------------------------------------------
# new-entity matching + admission
# ---------------------------------------------------------------------------


def match_candidates_to_memory(pool: EntityMemory, cand_embds: torch.Tensor, cand_valid: torch.Tensor,
                               threshold: float, embd_frames: int = 3):
    """Hungarian match of candidates to pool entities by the reference's
    QUASI-TRACK law (``use_quasi_track = True`` is hardcoded,
    inference_video_entity.py:157,:593-598): raw dot products per
    (prev-frame, cur-frame) pair, bisoftmax over entities and candidates
    averaged over pairs, sub-threshold similarities zeroed, Hungarian on
    (1 - sim).  Returns (cand2slot [Qc] int64 — slot or -1, matched_sim [Qc])."""
    E = pool.capacity
    Qc = cand_embds.shape[0]
    tgt = pool.embds[:, -embd_frames:]  # [E, F, C]
    pair = torch.einsum("nvc,mtc->nmvt", tgt, cand_embds).reshape(E, Qc, -1)
    neg = torch.full_like(pair, -1e9)
    s_rows = torch.where(pool.valid[:, None, None], pair, neg)
    s_cols = torch.where(cand_valid[None, :, None], pair, neg)
    sim = 0.5 * (torch.softmax(s_cols, dim=1) + torch.softmax(s_rows, dim=0)).mean(-1)
    sim = torch.where(sim < threshold, 0.0, sim)
    sim = torch.where(pool.valid[:, None] & cand_valid[None, :], sim, -1.0)
    if E <= Qc:
        slot2cand = hungarian(1.0 - sim, row_valid=pool.valid)  # [E]
        cand2slot = torch.full((Qc,), -1, dtype=torch.int64, device=sim.device)
        gate = slot2cand >= 0
        cand2slot[slot2cand[gate]] = torch.arange(E, device=sim.device)[gate]
    else:
        cand2slot = hungarian(1.0 - sim.T, row_valid=cand_valid)  # [Qc]
        slot_ok = pool.valid[cand2slot.clamp(min=0)] & (cand2slot >= 0)
        cand2slot = torch.where(slot_ok, cand2slot, -1)
    ar = torch.arange(Qc, device=sim.device)
    matched_sim = torch.where(cand2slot >= 0, sim[cand2slot.clamp(min=0), ar], -1.0)
    return cand2slot, matched_sim


def scatter_where_(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, gate: torch.Tensor) -> None:
    """In place: dst[idx[q]] = src[q] where gate[q] (gated indices are unique)."""
    dst[idx[gate]] = src[gate].to(dst.dtype)


def admit_entities(pool: EntityMemory, clip_offset: int, frame_idx: int, masks: torch.Tensor,
                   logits: torch.Tensor, embds_mean: torch.Tensor, quality: torch.Tensor,
                   is_new: torch.Tensor) -> EntityMemory:
    """Scatter new entities into free pool slots in slot order
    (reference: write_newly_entities_into_annotations_per_clip:767-876);
    candidates beyond the free capacity are dropped.  Only the clip's
    T-frame window slice is written: free slots' ring rows are all zero
    by invariant, as in the JAX package."""
    E = pool.capacity
    T = masks.shape[1]
    dev = pool.valid.device
    free = ~pool.valid
    cand_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    slot_idx = torch.where(free, torch.arange(E, device=dev), E)
    slot_order = torch.sort(slot_idx).values
    n_free = free.sum()
    take = torch.where((cand_rank < n_free) & is_new, cand_rank, E - 1)
    slot_for_cand = slot_order[take.clamp(0, E - 1)]
    admit = is_new & (cand_rank < n_free) & (slot_for_cand < E)

    slots = slot_for_cand[admit]
    win = window_slice(pool.mask_logits, clip_offset, T)
    win[slots] = masks[admit].to(win.dtype)
    occ = window_slice(pool.occurrence, clip_offset, T)
    occ[slots] = 1.0
    pool.embds[slots, -1] = embds_mean[admit].to(pool.embds.dtype)
    pool.valid[slots] = True
    pool.first_appear[slots] = int(frame_idx)
    pool.logits_sum[slots] = logits[admit].to(pool.logits_sum.dtype)
    pool.logits_count[slots] = 1.0
    pool.logits_last[slots] = logits[admit].to(pool.logits_last.dtype)
    pool.quality_sum[slots] = quality[admit].to(pool.quality_sum.dtype)
    return pool
