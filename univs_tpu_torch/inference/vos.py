"""Prompt-guided inference: VOS / PVOS (visual prompts) and RefVOS (text
prompts) — counterpart of ``univs_tpu/inference/vos.py``.

The number of target objects is known up front (GT first-frame masks or
referring expressions), so the pool uses exactly N slots.  GT masks are
injected into the mask window at each object's first-appearance frame;
the model re-segments through prompt queries, and the matched prompt
outputs are written back as pseudo-GT that drives the next clip's
prompts.

Update rules: first-appear objects take prompt-query masks with
inter-object argmax resolution weighted by mIoU^2 x quality and an mIoU
floor of 0.15 x area factor; appeared objects are gated by embedding
consistency (0.5), resolved by sim^2 x quality argmax with a mask-area
ratio > 0.25, then ADD-accumulated with (old + new) / (nonblank + 1)
embeddings.  ``query_mode``: ``"prompt"`` (prompt-query outputs only),
``"learn"`` (appeared objects re-identified among the learnable-query
outputs by Hungarian matching on temporally weighted cosine similarity,
threshold 0.65) or ``"prompt+learn"`` (both, fused per object by
similarity ratio; the prompt branch wins outright where the two masks
disagree, IoU < 0.5).  Grounding runs prompts only.

The pool is updated in place, as in ``entity_clip_step``; the clip
schedule (frame indices, offset) is host data.  Every window read is
the slice ``jax.lax.dynamic_slice_in_dim`` takes
(``memory_pool.window_slice``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from univs_tpu_torch.inference import memory_pool as mp
from univs_tpu_torch.inference.entity import EntityClipConfig, _reencode_prompts, mask_quality_scores
from univs_tpu_torch.losses.hungarian import hungarian
from univs_tpu_torch.ops import mask_ops
from univs_tpu_torch.structures import TextPrompts, VisualPrompts


def inject_gt_first_appearance(pool: mp.EntityMemory, gt_masks_clip: torch.Tensor,
                               faf: torch.Tensor, obj_valid: torch.Tensor,
                               frame_indices: Sequence[int], clip_offset: int) -> mp.EntityMemory:
    """Write GT masks (as +-10 logits) into the window at first
    appearance (replacing what is there) and mark the slots valid.

    gt_masks_clip [N, T, H4, W4] binary; faf [N] absolute first-appear
    frame (-1 never); obj_valid [N] bool."""
    frames = [int(f) for f in frame_indices]
    T = len(frames)
    fi = torch.as_tensor(frames, dtype=faf.dtype, device=faf.device)
    in_clip = (faf >= frames[0]) & (faf <= frames[-1]) & obj_valid
    here = in_clip[:, None] & (faf[:, None] == fi[None, :])  # [N, T]
    add = torch.where(here[:, :, None, None], gt_masks_clip * 20.0 - 10.0, 0.0)
    win = mp.window_slice(pool.mask_logits, clip_offset, T)
    win.copy_(torch.where(add != 0, add.to(win.dtype), win))
    occ = mp.window_slice(pool.occurrence, clip_offset, T)
    occ.copy_(torch.maximum(occ, here.to(occ.dtype)))
    pool.first_appear.copy_(torch.where(in_clip & (pool.first_appear < 0),
                                        faf.to(pool.first_appear.dtype), pool.first_appear))
    pool.valid |= in_clip
    return pool


def vos_clip_step(modules, encoded, pool: mp.EntityMemory, frame_indices: Sequence[int],
                  clip_offset: int, cls_emb: Optional[torch.Tensor], cc: EntityClipConfig,
                  text_prompts: Optional[TextPrompts] = None, task: str = "sot",
                  query_mode: str = "prompt") -> Tuple[mp.EntityMemory, Dict]:
    """One clip of prompt-guided re-segmentation; updates ``pool`` in
    place.  Returns (pool, aux): ``sim``, ``quality`` and the clip's
    decisions ``first_ok`` (first-appear objects written), ``gated``
    (appeared objects accumulated) and ``cons_l`` (learn-branch matches;
    None in 'prompt' mode), each [N] bool."""
    assert query_mode in ("prompt", "learn", "prompt+learn")
    if task == "grounding":
        query_mode = "prompt"  # prompts-as-queries only for referring segmentation
    _, decoder = modules
    frames = [int(f) for f in frame_indices]
    T = len(frames)
    mask_features, ms = encoded
    dev = mask_features.device
    fi = torch.as_tensor(frames, dtype=torch.int64, device=dev)[None]

    # step 0: re-encode prompts from committed frames (before the kv read);
    # the first clip commits frame 0 for VOS and nothing for grounding
    grid_feats, grid_pos = decoder.prompt_feature_grid(ms[-1], fi)
    is_first_clip = frames[0] == 0
    n_update = (0 if task == "grounding" else 1) if is_first_clip else T - cc.clip_stride
    _reencode_prompts(pool, grid_feats[0], grid_pos[0], clip_offset, n_update, T, cc,
                      first_frame=frames[0])

    if task == "grounding" and text_prompts is not None:
        vp = None
        if cc.prev_visual_prompts_for_grounding:
            # the prev-clip visual kv goes ahead of the text kv; on the
            # first clip the pool is uncommitted and its entries are zeros
            # (ProCA zero-bias tokens), as in the JAX package.  One prompt
            # set per expression: the decoder broadcasts it over T
            kv, _, kv_valid = mp.read_prompt_kv(pool, cc.num_prev_frames_memory)
            queries, query_pos = mp.read_clip_queries(pool, T)
            vp = VisualPrompts(queries=queries[None], query_pos=query_pos[None],
                               kv=kv[None, :, :, None], kv_pe=None,
                               kv_valid=kv_valid[None, :, :, None], valid=pool.valid[None])
        out = decoder(ms, mask_features, fi, task="grounding", text_prompts=text_prompts,
                      visual_prompts=vp)
    else:
        kv, kv_pe, kv_valid = mp.read_prompt_kv(pool, cc.num_prev_frames_memory)
        queries, query_pos = mp.read_clip_queries(pool, T)
        vp = VisualPrompts(queries=queries[None], query_pos=query_pos[None],
                           kv=kv[None, :, :, None], kv_pe=kv_pe[None, :, :, None],
                           kv_valid=kv_valid[None, :, :, None], valid=pool.valid[None])
        out = decoder(ms, mask_features, fi, task="sot", visual_prompts=vp, cls_emb=cls_emb)

    Ql = cc.num_queries
    masks_p = out["pred_masks"][0, Ql:].to(torch.float32)  # [N, T, H4, W4]
    embds_p = out["pred_embds"][0, Ql:].to(torch.float32)  # [N, T, C]
    quality = mask_quality_scores(masks_p)

    first_frame = frames[0]
    is_first_appear = (pool.first_appear >= first_frame) & (pool.first_appear <= frames[-1]) & pool.valid
    has_appeared = (pool.first_appear < first_frame) & (pool.first_appear >= 0) & pool.valid
    win = mp.window_slice(pool.mask_logits, clip_offset, T)
    occ = mp.window_slice(pool.occurrence, clip_offset, T)

    # first-appear objects: prompt-only re-segmentation, inter-object
    # overlap resolved by miou^2 * quality (grounding: quality only, no
    # miou gate, written from faf inclusive)
    is_grounding = task == "grounding"
    faf_local = (pool.first_appear - first_frame).clamp(0, T - 1).to(torch.int64)
    at_faf = faf_local[:, None, None, None]
    gt_at_faf = torch.take_along_dim(win, at_faf, dim=1)[:, 0] > 0
    pred_at_faf = torch.take_along_dim(masks_p, at_faf, dim=1)[:, 0] > 0
    miou = _pair_mask_iou(gt_at_faf, pred_at_faf)
    w_first = quality if is_grounding else miou ** 2 * quality
    resolved_first = _overlap_resolve(masks_p, w_first, is_first_appear)
    # miou floor: 0.15 * clamp(area / 96^2, max=1)
    area_factor = (gt_at_faf.sum((-2, -1)).to(torch.float32) / (96.0 * 96.0)).clamp(0.0, 1.0)
    resolved_bin = torch.take_along_dim(resolved_first > 0, at_faf, dim=1)[:, 0]
    miou2 = _pair_mask_iou(gt_at_faf, resolved_bin)
    first_ok = is_first_appear if is_grounding else is_first_appear & (miou2 > 0.15 * area_factor)

    ar = torch.arange(T, device=dev)[None, :]
    after = ar >= faf_local[:, None] if is_grounding else ar > faf_local[:, None]
    wrt = first_ok[:, None] & after  # [N, T]
    new_win = torch.where(wrt[:, :, None, None], resolved_first.to(win.dtype), win)
    new_occ = torch.where(wrt, 1.0, occ)
    old = pool.embds[:, -1]
    embds_last = torch.where(first_ok[:, None], embds_p.mean(1), old)

    # appeared objects: consistency-gated accumulation, branch per query_mode
    cons_l = None
    if query_mode != "prompt":
        masks_l_all = out["pred_masks"][0, :Ql].to(torch.float32)
        embds_l_all = out["pred_embds"][0, :Ql].to(torch.float32)
        slot2cand, sim_l = match_learn_appeared(pool, embds_l_all, cc.num_prev_frames_memory)
        cons_l = sim_l >= 0.65
        sel = slot2cand.clamp(min=0)
        masks_l = torch.where(cons_l[:, None, None, None], masks_l_all[sel], 0.0)
        embds_l = torch.where(cons_l[:, None, None], embds_l_all[sel], 0.0)
        sim_l = torch.where(cons_l, sim_l, 0.0)

    is_cons, sim_p = mp.consistency_gate(pool, embds_p, cc.num_prev_frames_memory, 0.5)
    sim_p = torch.where(is_cons, sim_p, 0.0)

    if query_mode == "prompt":
        masks_app, embds_app, quality_app, sim = masks_p, embds_p, quality, sim_p
        gated = has_appeared & is_cons
    elif query_mode == "learn":
        masks_app, embds_app, sim = masks_l, embds_l, sim_l
        quality_app = mask_quality_scores(masks_app)
        gated = has_appeared & cons_l
    else:  # prompt+learn fusion
        n_active = (sim_p > 0).to(torch.float32) + (sim_l > 0).to(torch.float32)
        sim = (sim_p + sim_l) / n_active.clamp(min=1.0)
        den = (sim_p + sim_l).clamp(min=1e-5)
        w_p, w_l = sim_p / den, sim_l / den
        masks_pg = torch.where(is_cons[:, None, None, None], masks_p, 0.0)
        siou_up = ((masks_pg > 0) & (masks_l > 0)).sum((-3, -2, -1)).to(torch.float32)
        siou_dn = ((masks_pg > 0) | (masks_l > 0)).sum((-3, -2, -1)).to(torch.float32)
        disagree = siou_up / siou_dn.clamp(min=1.0) < 0.5
        w_p = torch.where(disagree, 1.0, w_p)
        w_l = torch.where(disagree, 0.0, w_l)
        masks_app = w_p[:, None, None, None] * masks_pg + w_l[:, None, None, None] * masks_l
        embds_app = (w_p[:, None, None] * torch.where(is_cons[:, None, None], embds_p, 0.0)
                     + w_l[:, None, None] * embds_l)
        quality_app = mask_quality_scores(masks_app)
        gated = has_appeared & (is_cons | cons_l)

    resolved_app = _overlap_resolve(masks_app, sim ** 2 * quality_app, gated)
    # area-ratio gate 0.25
    orig_area = (masks_app > 0).sum((-3, -2, -1)).clamp(min=1)
    res_area = (resolved_app > 0).sum((-3, -2, -1))
    gated = gated & ((res_area / orig_area) > 0.25)
    new_win = new_win + torch.where(gated[:, None, None, None], resolved_app.to(win.dtype), 0.0)
    nonblank_t = (resolved_app > 0).flatten(2).any(-1).to(occ.dtype)  # [N, T]
    new_occ = new_occ + torch.where(gated[:, None], nonblank_t, 0.0)
    nonblank_e = (old != 0).any(-1)
    upd_e = (old + embds_app.mean(1)) / (nonblank_e[:, None].to(torch.float32) + 1.0)
    embds_last = torch.where(gated[:, None], upd_e, embds_last)

    win.copy_(new_win)
    occ.copy_(new_occ)
    pool.embds[:, -1] = embds_last
    pool.quality_sum.copy_(pool.quality_sum + torch.where(first_ok, quality, 0.0)
                           + torch.where(gated, quality_app, 0.0))
    return pool, {"sim": sim, "quality": quality, "first_ok": first_ok, "gated": gated,
                  "cons_l": cons_l}


def _topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, ties in index order
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def match_learn_first_appear(masks_l: torch.Tensor, gt_at_faf: torch.Tensor,
                             faf_local: torch.Tensor, topk: int = 5) -> torch.Tensor:
    """First-appearance re-ID against learnable queries: box-IoU top-k
    candidates, then mask-IoU argmax.  masks_l [Q, T, H, W] logits,
    gt_at_faf [N, H, W], faf_local [N] -> [N] int32 learnable-query index
    per object.  Box IoU in pixel coordinates."""
    Q = masks_l.shape[0]
    pred_faf = masks_l[:, faf_local.to(torch.int64)].transpose(0, 1) > 0  # [N, Q, H, W]
    gt_b = gt_at_faf > 0
    gt_boxes = mask_ops.masks_to_boxes(gt_b)  # [N, 4]
    pred_boxes = mask_ops.masks_to_boxes(pred_faf)  # [N, Q, 4]
    lt = torch.maximum(gt_boxes[:, None, :2], pred_boxes[..., :2])
    rb = torch.minimum(gt_boxes[:, None, 2:], pred_boxes[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_g = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    area_p = (pred_boxes[..., 2] - pred_boxes[..., 0]) * (pred_boxes[..., 3] - pred_boxes[..., 1])
    biou = inter / (area_g[:, None] + area_p - inter).clamp(min=1e-6)  # [N, Q]
    top_idx = _topk_stable(biou, min(topk, Q))  # [N, k]
    cand = torch.take_along_dim(pred_faf, top_idx[:, :, None, None], dim=1)
    inter_m = (cand & gt_b[:, None]).sum((-2, -1)).to(torch.float32)
    union_m = (cand | gt_b[:, None]).sum((-2, -1)).to(torch.float32)
    best = torch.argmax(inter_m / union_m.clamp(min=1.0), dim=-1)  # first maximum
    return torch.take_along_dim(top_idx, best[:, None], dim=1)[:, 0].to(torch.int32)


def match_learn_appeared(pool: mp.EntityMemory, embds_l: torch.Tensor, num_prev: int,
                         use_norm: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hungarian re-ID of pool targets against learnable-query embeddings
    [Q, T, C].  ``use_norm``: temporally weighted cosine similarity, else
    bisoftmax of scaled dot products.  Returns (slot2cand [N] int64, -1
    for empty slots, sim [N])."""
    N = pool.capacity
    assert N <= embds_l.shape[0], "pool capacity must not exceed learnable query count"
    tgt = pool.embds[:, -num_prev:]  # [N, F, C]
    F = tgt.shape[1]
    if use_norm:
        t_n = tgt / torch.linalg.norm(tgt, dim=-1, keepdim=True).clamp(min=1e-3)
        c_n = embds_l / torch.linalg.norm(embds_l, dim=-1, keepdim=True).clamp(min=1e-3)
        sim = torch.einsum("nvc,qtc->nqv", t_n, c_n.to(t_n.dtype)) / embds_l.shape[1]
        nonblank = (tgt != 0).any(-1).to(torch.float32)  # [N, F]
        w = torch.exp(torch.arange(1, F + 1, dtype=torch.float32, device=tgt.device) / F * 5.0)
        w = w[None] * nonblank
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-3)
        sim = (sim * w[:, None]).sum(-1)  # [N, Q]
    else:
        sim = torch.einsum("nvc,qtc->nq", tgt, embds_l) / (
            F * embds_l.shape[1] * torch.sqrt(torch.tensor(float(tgt.shape[-1]))))
        sim = 0.5 * (torch.softmax(sim, dim=0) + torch.softmax(sim, dim=1))
    sim = torch.where(pool.valid[:, None], sim, -1.0)
    slot2cand = hungarian(1.0 - sim, row_valid=pool.valid)
    sim_m = sim[torch.arange(N, device=sim.device), slot2cand.clamp(min=0)]
    return slot2cand, torch.where(slot2cand >= 0, sim_m, 0.0)


def _pair_mask_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Paired IoU: a, b [N, H, W] binary -> [N]."""
    af = a.reshape(a.shape[0], -1).to(torch.float32)
    bf = b.reshape(b.shape[0], -1).to(torch.float32)
    inter = (af * bf).sum(-1)
    return inter / (af.sum(-1) + bf.sum(-1) - inter).clamp(min=1.0)


def _overlap_resolve(masks: torch.Tensor, weights: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Pixel-wise argmax resolution between competing objects: masks [N,
    T, H, W] logits, weights [N], active [N] bool.  A pixel belongs to the
    active object with the largest weighted sigmoid (first index on a
    tie; inactive objects at -1 never win), background where no active
    object exceeds 0 logits.  Returns masks zeroed outside each object's
    owned region."""
    w = torch.where(active, weights, 0.0)
    prob = torch.sigmoid(masks) * w[:, None, None, None]
    prob = torch.where(active[:, None, None, None], prob, -1.0)
    owner = torch.argmax(prob, dim=0)  # [T, H, W]
    any_fg = torch.where(active[:, None, None, None], masks, -1.0).amax(0) > 0
    own = (owner[None] == torch.arange(masks.shape[0], device=masks.device)[:, None, None, None])
    return masks * (own & any_fg[None])
