"""Category-guided video inference, VIS / VPS / VSS — counterpart of
``univs_tpu/inference/entity.py``.

One clip step: re-encode mask prompts from the pool's committed frames,
run the sot decode with memory-pool prompt queries (ProCA), gate tracked
entities by embedding consistency and mask overlap, accumulate their
masks, then detect new entities from the learnable queries (quality-
scored top-k, triu-law box NMS, quasi-track bisoftmax Hungarian against
the pool, matched updates, class + overlap admission).  The pool is
updated in place.  The clip schedule (offsets, first-clip flag, frame
indices) is host data, so every branch on it is a Python branch.

Thresholds as the reference (inference_video_entity.py): consistency
0.25 (halved while the clip starts within the first T frames), newly-
entity match 0.1, class 0.25, box NMS 0.85, overlap 0.8.  Two newly-
entity variants, as the reference dispatches them
(inference_video_entity.py:367-370): 'instance' (VIS) and 'pixel' (VPS
panoptic, with the dataset's thing classes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from univs_tpu_torch.inference import memory_pool as mp
from univs_tpu_torch.ops import mask_ops
from univs_tpu_torch.prompts.visual_prompt import sample_visual_prompts
from univs_tpu_torch.structures import VisualPrompts


def mask_quality_scores(mask_logits: torch.Tensor) -> torch.Tensor:
    """Stability score: IoU of the masks thresholded at +1 and -1 logit
    (calculate_mask_quality_scores — univs/utils/comm.py).  The +1 mask
    lies inside the -1 mask, so the intersection is the +1 count."""
    n = mask_logits.shape[0]
    hi = (mask_logits > 1.0).reshape(n, -1).sum(-1).to(torch.float32)
    lo = (mask_logits > -1.0).reshape(n, -1).sum(-1).to(torch.float32)
    return hi / lo.clamp(min=1.0)


@dataclass(frozen=True)
class EntityClipConfig:
    """Knobs of the clip step (the JAX package's fields, less its
    measurement-only ``ablate``)."""

    num_queries: int = 200
    topk_candidates: int = 25
    num_prev_frames_memory: int = 5
    apply_cls_thres: float = 0.25
    newly_thres: float = 0.1
    consistency_thres: float = 0.25
    nms_thres: float = 0.85
    overlap_thres: float = 0.8
    # candidates need a mask quality above this (instance variant; 0 = off)
    stability_thres: float = 0.0
    num_dense_points: int = 128
    clip_stride: int = 1
    num_frames: int = 5
    # newly-entity detection: 'instance' (VIS) or 'pixel' (VPS panoptic)
    variant: str = "instance"
    # RefVOS: concat the prev-clip visual prompt kv ahead of the text kv
    # (ENABLED_PREV_VISUAL_PROMPTS_FOR_GROUNDING, decoder_univs.py:736-748)
    prev_visual_prompts_for_grounding: bool = False
    detect_newly_interval_frames: int = 1


def entity_clip_step(modules, encoded, pool: mp.EntityMemory, frame_indices: Sequence[int],
                     clip_offset: int, is_first_clip: bool, cls_emb: torch.Tensor,
                     cc: EntityClipConfig,
                     thing_mask: Optional[torch.Tensor] = None) -> mp.EntityMemory:
    """One clip of category-guided inference; updates ``pool`` in place
    and returns it.

    modules: (pixel_decoder, decoder); encoded: (mask_features [T, h4,
    w4, C], multi-scale tuple) — per-frame pixel-decoder outputs sliced
    from the window encode; frame_indices: T absolute frame indices;
    clip_offset: first clip frame relative to the pool window;
    thing_mask: [K] bool thing classes of the pixel variant (None: all)."""
    _, decoder = modules
    frames = [int(f) for f in frame_indices]
    T = len(frames)
    E = pool.capacity
    mask_features, ms = encoded
    dev = mask_features.device
    fi = torch.as_tensor(frames, dtype=torch.int64, device=dev)[None]

    # step 0: re-encode prompts from committed frames (before the kv read)
    grid_feats, grid_pos = decoder.prompt_feature_grid(ms[-1], fi)
    n_update = 1 if is_first_clip else T - cc.clip_stride
    _reencode_prompts(pool, grid_feats[0], grid_pos[0], clip_offset, n_update, T, cc,
                      first_frame=frames[0])

    kv, kv_pe, kv_valid = mp.read_prompt_kv(pool, cc.num_prev_frames_memory)
    queries, query_pos = mp.read_clip_queries(pool, T)
    vp = VisualPrompts(
        queries=queries[None], query_pos=query_pos[None],
        # singleton frame axis: one prompt set per entity for every frame
        kv=kv[None, :, :, None], kv_pe=kv_pe[None, :, :, None],
        kv_valid=kv_valid[None, :, :, None], valid=pool.valid[None],
    )
    out = decoder(ms, mask_features, fi, task="sot", visual_prompts=vp, cls_emb=cls_emb)
    Ql = cc.num_queries
    logits = torch.sigmoid(out["pred_logits"][0].to(torch.float32))  # [Q, K]
    masks = out["pred_masks"][0]  # [Q, T, H4, W4], compute dtype
    embds = out["pred_embds"][0].to(torch.float32)  # [Q, T, C]
    logits_l, logits_p = logits[:Ql], logits[Ql:]
    masks_l, masks_p = masks[:Ql], masks[Ql:]
    embds_l, embds_p = embds[:Ql], embds[Ql:]

    # step 1: update tracked entities from the prompt queries
    q_p = mask_quality_scores(masks_p)
    thr = cc.consistency_thres * (0.5 if (is_first_clip or frames[0] < cc.num_frames) else 1.0)
    is_cons, sim_cons = mp.consistency_gate(
        pool, embds_p, max(cc.num_prev_frames_memory // max(cc.clip_stride, 1), 3), thr)
    # VIS overlap resolution (reference :477-491)
    scores_track = (pool.logits_sum / pool.logits_count.clamp(min=1)[:, None]).amax(-1)
    cur_scores = scores_track * sim_cons * q_p
    prob = torch.sigmoid(masks_p).reshape(E, -1)
    is_bg = (prob < 0.5).all(0)
    owner = torch.argmax(cur_scores[:, None] * prob, dim=0)
    owner = torch.where(is_bg, -1, owner)
    own_mask = owner[None, :] == torch.arange(E, device=dev)[:, None]
    orig_area = (prob > 0.5).sum(-1).clamp(min=1)
    own_area = own_mask.sum(-1)
    above_ratio = (own_area / orig_area) > cc.overlap_thres
    mask_over = (own_mask & (prob > 0.5)).any(-1)
    update = is_cons & above_ratio & mask_over
    mp.accumulate_clip_masks(pool, clip_offset, masks_p, embds_p.mean(1), update, q_p)

    # step 2: detect new entities from the learnable queries, every k-th
    # clip or whenever the pool is empty (inference_video_entity.py:366)
    detect = True
    if cc.detect_newly_interval_frames > 1:
        clip_idx = frames[0] // max(cc.clip_stride, 1)
        detect = clip_idx % cc.detect_newly_interval_frames == 0 or not bool(pool.valid.any())
    if detect and cc.variant == "pixel":
        _detect_newly_pixel(pool, clip_offset, frames, is_first_clip, logits_l, masks_l, embds_l,
                            thing_mask, cc)
    elif detect:
        _detect_newly_instance(pool, clip_offset, frames, is_first_clip, logits_l, masks_l,
                               embds_l, cc)

    return pool


def _detect_newly_instance(pool, clip_offset, frames, is_first_clip, logits_l, masks_l, embds_l,
                           cc: EntityClipConfig):
    """VIS newly-entity detection (detect_newly_entities_per_clip_instance,
    inference_video_entity.py:517-652)."""
    Ql = logits_l.shape[0]
    dev = logits_l.device
    q_l = mask_quality_scores(masks_l)
    scored = logits_l * q_l[:, None]
    nms_scores = scored.amax(-1)
    if cc.stability_thres > 0:
        nms_scores = torch.where(q_l > cc.stability_thres, nms_scores, -1.0)
    k = min(cc.topk_candidates, Ql)
    # top-k with ties in index order (as lax.top_k)
    top_vals, top_idx = torch.sort(nms_scores, descending=True, stable=True)
    top_vals, top_idx = top_vals[:k], top_idx[:k]
    c_logits, c_masks = scored[top_idx], masks_l[top_idx]
    c_embds, c_quality = embds_l[top_idx], q_l[top_idx]
    c_valid = top_vals > 0

    H4, W4 = c_masks.shape[-2:]
    norm = torch.tensor([W4, H4, W4, H4], dtype=torch.float32, device=dev)
    c_boxes_t = mask_ops.masks_to_boxes(c_masks > 0) / norm  # [Qc, T, 4]
    # dedup on per-frame box IoU max over time — triu law (reference :551-559)
    biou = mask_ops.box_iou(c_boxes_t.transpose(0, 1), c_boxes_t.transpose(0, 1)).amax(0)
    order_scores = torch.where(c_valid, c_logits.amax(-1), -1.0)
    keep = mask_ops.nms_triu_keep_from_iou(biou, order_scores, cc.nms_thres, c_valid)
    c_valid = c_valid & keep

    cand2slot, matched_sim = mp.match_candidates_to_memory(pool, c_embds, c_valid, cc.newly_thres)
    matched = (matched_sim > cc.newly_thres) & (cand2slot >= 0) & c_valid
    # matched entities take the learnable queries' logits / embds (:609-612)
    _update_matched(pool, cand2slot, matched, c_logits, c_embds)
    # strong matches also add their masks (:618-629)
    strong = (matched_sim > 2 * cc.newly_thres) & matched
    _accumulate_candidate_masks(pool, clip_offset, c_masks, c_quality, cand2slot, strong)

    # newly = unmatched, confident, low overlap with the pool (:641-646)
    miou_max = _max_iou_with_pool(pool, clip_offset, c_masks)
    conf = c_logits.amax(-1)
    cls_gate = max(cc.apply_cls_thres, 0.1) if is_first_clip else cc.apply_cls_thres
    is_new = c_valid & ~matched & (conf > cls_gate)
    if not is_first_clip:
        is_new = is_new & (miou_max < 0.5)
    mp.admit_entities(pool, clip_offset, frames[0], c_masks, c_logits, c_embds.mean(1),
                      c_quality, is_new)


def _rank_within(mask: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Rank (0 = best) by descending score among ``mask`` members, ties in
    index order (a stable sort, as ``jnp.argsort``); others 1 << 30."""
    s = torch.where(mask, scores, -torch.inf)
    order = torch.argsort(-s, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return torch.where(mask, rank, 1 << 30)


def _detect_newly_pixel(pool, clip_offset, frames, is_first_clip, logits_l, masks_l, embds_l,
                        thing_mask, cc: EntityClipConfig):
    """VPS (panoptic) newly-entity detection (detect_newly_entities_per_
    clip_pixel, inference_video_entity.py:654-765).  First clip: the
    score-ranked top 100 split by thing / stuff class, the top 70 things
    deduped by triu-law box NMS (nms_thres), the top 30 stuff by triu-law
    frame-0 mask IoU at 0.6, admitted above apply_cls_thres.  Later
    clips: no NMS; all learnable queries are matched to the pool by the
    quasi-track law, every match adds its masks / logits / embds, and the
    unmatched above 2 x apply_cls_thres with mask IoU < 0.5 against the
    pool are admitted.  (The JAX package computes both branches and
    selects; on the first clip its matches are all masked off.)"""
    Ql, K = logits_l.shape
    dev = logits_l.device
    q_l = mask_quality_scores(masks_l)
    scored = logits_l * q_l[:, None]  # [Ql, K]
    s = scored.amax(-1)
    all_q = torch.ones((Ql,), dtype=torch.bool, device=dev)

    if is_first_clip:  # (:671-698)
        if thing_mask is None:
            thing_mask = torch.ones((K,), dtype=torch.bool, device=dev)
        isthing = thing_mask.to(dev)[scored.argmax(-1)]
        in100 = _rank_within(all_q, s) < 100
        cand_t = _rank_within(isthing & in100, s) < 70
        cand_s = _rank_within(~isthing & in100, s) < 30
        H4, W4 = masks_l.shape[-2:]
        norm = torch.tensor([W4, H4, W4, H4], dtype=torch.float32, device=dev)
        boxes_t = mask_ops.masks_to_boxes(masks_l > 0) / norm  # [Ql, T, 4]
        biou = mask_ops.box_iou(boxes_t.transpose(0, 1), boxes_t.transpose(0, 1)).amax(0)
        keep_t = mask_ops.nms_triu_keep_from_iou(biou, s, cc.nms_thres, cand_t)
        m0 = masks_l[:, 0] > 0
        keep_s = mask_ops.nms_triu_keep_from_iou(mask_ops.pairwise_mask_iou(m0, m0), s, 0.6, cand_s)
        is_new = (keep_t | keep_s) & (s > cc.apply_cls_thres)
    else:  # (:711-746)
        cand2slot, matched_sim = mp.match_candidates_to_memory(pool, embds_l, all_q, cc.newly_thres)
        matched = (matched_sim > cc.newly_thres) & (cand2slot >= 0)
        _update_matched(pool, cand2slot, matched, scored, embds_l)
        # every matched candidate adds its masks (:727-740, no 2x gate)
        _accumulate_candidate_masks(pool, clip_offset, masks_l, q_l, cand2slot, matched)
        miou_max = _max_iou_with_pool(pool, clip_offset, masks_l)
        is_new = ~matched & (s > 2 * cc.apply_cls_thres) & (miou_max < 0.5)
    mp.admit_entities(pool, clip_offset, frames[0], masks_l, scored, embds_l.mean(1), q_l, is_new)


def _update_matched(pool, cand2slot, matched, logits, embds):
    """Matched candidates update their pool slots in place: logits_last
    becomes the mean of the old and the candidate's, the newest embedding
    the mean of the old (if non-blank) and the candidate's clip mean."""
    slot = cand2slot.clamp(min=0)
    upd_logits = 0.5 * (pool.logits_last[slot] + logits)
    old_emb = pool.embds[slot, -1]
    nonblank = (old_emb != 0).any(-1)
    new_emb = (old_emb + embds.mean(1)) / (nonblank[:, None].to(torch.float32) + 1.0)
    mp.scatter_where_(pool.logits_last, cand2slot, upd_logits, matched)
    last = pool.embds[:, -1].clone()
    mp.scatter_where_(last, cand2slot, new_emb, matched)
    pool.embds[:, -1] = last


def _max_iou_with_pool(pool, clip_offset, masks):
    """Each candidate's largest mask IoU (logit > 0, over the clip's
    frames) with a valid pool entity -> [Qc]."""
    T = masks.shape[1]
    win = mp.window_slice(pool.mask_logits, clip_offset, T)
    pool_bin = (win > 0).reshape(pool.capacity, -1).to(torch.float32)
    cand_bin = (masks > 0).reshape(masks.shape[0], -1).to(torch.float32)
    # exact counts: float32 products of 0/1 with float32 accumulation
    inter = cand_bin @ pool_bin.T
    union = (cand_bin.sum(-1)[:, None] + pool_bin.sum(-1)[None] - inter).clamp(min=1)
    return torch.where(pool.valid[None], inter / union, 0.0).amax(-1)


def _accumulate_candidate_masks(pool, clip_offset, c_masks, c_quality, cand2slot, gate):
    """Add gated candidates' mask logits onto their matched pool slots."""
    T = c_masks.shape[1]
    slots = cand2slot[gate]
    nonblank = (c_masks > 0).flatten(2).any(-1).to(pool.occurrence.dtype)  # [Qc, T]
    win = mp.window_slice(pool.mask_logits, clip_offset, T)
    win.index_add_(0, slots, c_masks[gate].to(win.dtype))
    mp.window_slice(pool.occurrence, clip_offset, T).index_add_(0, slots, nonblank[gate])
    pool.quality_sum.index_add_(0, slots, c_quality[gate].to(pool.quality_sum.dtype))


def _reencode_prompts(pool, grid_feats, grid_pos, clip_offset, n_update, T, cc: EntityClipConfig,
                      first_frame=None):
    """Re-encode mask prompts for this clip's committed frames and write
    them into the prompt ring with the reference's slot-overwrite cascade
    (VisualPromptSampler.process_per_video_inference,
    prompt_encoder.py:883-946): slot j holds the sample of the largest
    valid key frame <= min(j, n_update-1).  Entities whose first
    appearance falls on frame ``first_frame + j`` get their
    first-appearance set refreshed from slot j."""
    E = pool.capacity
    Fp = pool.prompt_feats.shape[2]
    R = cc.num_dense_points
    C = grid_feats.shape[-1]
    dev = grid_feats.device
    cur_f = torch.zeros((E, R, C), dtype=pool.prompt_feats.dtype, device=dev)
    cur_p = torch.zeros((E, R, C), dtype=pool.prompt_pe.dtype, device=dev)
    written = torch.zeros((E,), dtype=torch.bool, device=dev)
    snaps = []
    # key frames beyond max(1, T - stride) never commit (k < n_update)
    n_keys = min(T, max(1, T - cc.clip_stride))
    for k in range(n_keys):
        msk = (mp.window_slice(pool.mask_logits, clip_offset + k, 1)[:, 0] > 0).to(torch.float32)
        occur = msk.flatten(1).any(-1)
        sample = sample_visual_prompts(grid_feats[k], grid_pos[k], msk, occur, R)
        upd = pool.valid & sample.valid & (k < n_update)
        cur_f = torch.where(upd[:, None, None], sample.kv.to(cur_f.dtype), cur_f)
        cur_p = torch.where(upd[:, None, None], sample.kv_pe.to(cur_p.dtype), cur_p)
        written = written | upd
        snaps.append((cur_f, cur_p, written))

    last_k = max(n_update - 1, 0)
    for j in range(T):
        s_f, s_p, s_w = snaps[min(j, last_k)]
        slot = Fp - T + j
        pool.prompt_feats[:, :, slot] = torch.where(s_w[:, None, None], s_f, pool.prompt_feats[:, :, slot])
        pool.prompt_pe[:, :, slot] = torch.where(s_w[:, None, None], s_p, pool.prompt_pe[:, :, slot])
        pool.prompt_valid[:, :, slot] |= s_w[:, None]
        if first_frame is not None:
            refresh = s_w & (pool.first_appear == first_frame + j)
            pool.first_feats.copy_(torch.where(refresh[:, None, None], s_f, pool.first_feats))
            pool.first_pe.copy_(torch.where(refresh[:, None, None], s_p, pool.first_pe))
            pool.first_valid |= refresh[:, None]
    return pool
