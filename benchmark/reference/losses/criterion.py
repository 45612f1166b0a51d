"""Unified training criterion, learnable and prompt queries (counterpart
of ``univs_tpu/losses/criterion.py``), BoxVIS's box-projection loss and
its EMA teacher's pseudo masks included.

The same laws over fixed-capacity targets: targets padded to N slots
with a validity mask, every loss a masked reduction, the learnable
queries Hungarian-matched once per supervision layer and video, the
prompt queries bound to their targets, learnable and prompt halves
averaged 0.5 / 0.5 where both give a loss
(video_criterion_uni.py:154-158), names and weights of the reference's
weight_dict (univs_prompt.py:251-283).

Where the JAX package runs the assignment on the device inside its jit,
the port builds every layer's and video's cost matrix on the device
first and solves them all from ONE host copy (``hungarian_batch``, the
exact float32 JV, so the assignments are the same).  Random draws (the
matcher's points, the PointRend points, the contrastive losses' column
subsample) come from a ``DrawKey`` at the JAX package's key addresses
and enter each law as arguments.  ``uncertainty_point_coords`` takes
the most uncertain candidates by a stable descending sort where JAX
takes ``lax.top_k`` (same order, ties by index).

Every law takes a ``BatchShard`` (``parallel/ddp.py``): in one process
it is the whole batch and changes nothing; under data parallelism every
batch reduction of a count is global, the contrastive columns are every
rank's rows, and the per-video and per-row draws are this rank's slice of
the global batch's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.config import TrainConfig
from benchmark.reference.losses.hungarian import hungarian_batch
from benchmark.reference.parallel.ddp import BatchShard

# Parity hooks, as the JAX package's: when set, replace the random point
# generators.  _FIXED_MATCH_COORDS: [P, 2] matcher point set;
# _FIXED_LOSS_COORDS: callable (R, P) -> [R, P, 2] PointRend replacement.
_FIXED_MATCH_COORDS = None
_FIXED_LOSS_COORDS = None


@dataclass
class TrainTargets:
    """Fixed-capacity ground truth of a batch of clips.  Labels are
    1-based (0 = padding); masks at any resolution (the point losses
    sample in normalized coordinates).  ``sem_labels`` / ``sem_masks``:
    text-detection's semantic targets (per-category union masks), else
    None and the prompt slots index ``masks``."""

    labels: torch.Tensor  # [B, N] int, 1-based, 0 pad
    ids: torch.Tensor  # [B, N, T] int track ids, -1 absent
    masks: torch.Tensor  # [B, N, T, H, W] float {0, 1}
    valid: torch.Tensor  # [B, N] bool
    prompt_obj_ids: torch.Tensor  # [B, Qp] int -> target slot, -1 invalid
    sem_labels: Optional[torch.Tensor] = None  # [B, S]
    sem_masks: Optional[torch.Tensor] = None  # [B, S, T, H, W]

    def to(self, device) -> "TrainTargets":
        return TrainTargets(*(None if x is None else x.to(device) for x in (
            self.labels, self.ids, self.masks, self.valid, self.prompt_obj_ids,
            self.sem_labels, self.sem_masks)))


# ---------------------------------------------------------------------------
# loss primitives (video_criterion.py:22-223)
# ---------------------------------------------------------------------------


def dice_loss_points(logits: torch.Tensor, labels: torch.Tensor,
                     already_prob: bool = False) -> torch.Tensor:
    """Per-row dice loss over sampled points: [R, P] -> [R]."""
    p = logits if already_prob else torch.sigmoid(logits)
    num = 2 * (p * labels).sum(-1)
    den = p.sum(-1) + labels.sum(-1)
    return 1 - (num + 1) / (den + 1)


def sigmoid_ce_points(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row mean BCE over sampled points: [R, P] -> [R]."""
    return -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits)).mean(-1)


def focal_conf_sigmoid(logits: torch.Tensor, targets: torch.Tensor, col_valid: torch.Tensor,
                       alpha: float = 0.5, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss summed over valid classes: [Q, K] -> [Q]."""
    logpt = F.logsigmoid(logits * (targets * 2.0 - 1.0))
    pt = torch.exp(logpt)
    at = alpha * targets + (1 - alpha) * (1 - targets)
    loss = -at * (1 - pt) ** gamma * logpt
    return (loss * col_valid[None, :]).sum(-1)


def draw_gumbel_pair(key, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contrastive loss's column-subsample noise: two [n] Gumbel draws
    at the addresses of ``contrastive_loss``'s ``split(rng)``."""
    r1, r2 = key.split(2)
    return r1.gumbel((n,)), r2.gumbel((n,))


def _identity(x):
    return x


def contrastive_loss(sim: torch.Tensor, pos: torch.Tensor, row_valid: torch.Tensor,
                     col_valid: torch.Tensor, gumbel=None, topk: int = 20,
                     count=_identity) -> torch.Tensor:
    """Masked reference contrastive loss (video_criterion.py:166-200):
    sim [R, K], pos [R, K] {0, 1} -> scalar.  With ``gumbel`` (two [K]
    noise vectors) the negatives are a random column subset as the
    reference's (:184-188): up to int(0.75 * cap) columns holding a
    positive and int(0.25 * cap) background columns, cap = min(topk,
    3 * rows kept); without, the full negative set.  ``count`` makes a
    count over the rows global (data parallelism: each rank holds some
    rows, every column)."""
    f32 = torch.float32
    pos = pos * row_valid[:, None].to(f32) * col_valid[None, :].to(f32)
    keep = row_valid.to(f32) * (pos.sum(-1) > 0).to(f32)
    n_keep = count(keep.sum())
    # the anchor is the FIRST positive column (video_criterion.py:178-179)
    first_pos = torch.argmax(pos, dim=-1)
    pos_first = torch.gather(sim, 1, first_pos[:, None])[:, 0]
    pos_mean = (sim * pos).sum(-1) / pos.sum(-1).clamp(min=1)
    pos_two = torch.stack([pos_first, pos_mean], dim=-1)  # [R, 2]
    col_sel = col_valid.to(f32)
    if gumbel is not None:
        cap = min(topk, 3 * int(n_keep))
        n_act, n_bg = int(0.75 * cap), int(0.25 * cap)
        col_pos = count(pos.sum(0))
        col_act = (col_pos > 0) & col_valid
        col_bg = (col_pos == 0) & col_valid

        def pick(noise, mask, n):
            g = torch.where(mask, noise.to(sim.device), -1e9)
            rank = torch.argsort(torch.argsort(-g, stable=True), stable=True)
            return mask & (rank < n)

        col_sel = (pick(gumbel[0], col_act, n_act) | pick(gumbel[1], col_bg, n_bg)).to(f32)
    is_neg = (1 - pos) * col_sel[None, :]
    diff = sim[:, :, None] - pos_two[:, None, :]  # [R, K, 2]
    e = torch.exp(diff.clamp(max=10.0)) * is_neg[:, :, None]
    loss_row = torch.log1p(e.reshape(e.shape[0], -1).sum(-1))
    return (loss_row * keep).sum() / n_keep.clamp(min=1.0)


def contrastive_aux_loss(sim: torch.Tensor, pos: torch.Tensor, row_valid: torch.Tensor,
                         col_valid: torch.Tensor, count=_identity) -> torch.Tensor:
    """Masked smooth-L1 on cosine similarities (video_criterion.py:202-223)."""
    f32 = torch.float32
    pos = pos * col_valid[None, :].to(f32)
    keep = row_valid & (pos.sum(-1) > 0)
    d = (sim.clamp(min=0.0) - pos).abs()
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    sl1 = sl1 * col_valid[None, :].to(f32) * keep[:, None].to(f32)
    return sl1.sum() / count(keep.sum()).clamp(min=1).to(f32)


def point_sample_rows(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples in float32 (align_corners=False, zero padding):
    maps [R, H, W] (or [R, C, H, W]), coords [R, P, 2] (x, y) in [0, 1]
    -> [R, P] (or [R, P, C])."""
    x = maps.to(torch.float32)
    chan = x.dim() == 4
    if not chan:
        x = x[:, None]
    grid = (coords.to(torch.float32) * 2.0 - 1.0)[:, None]  # [R, 1, P, 2]
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    out = out[:, :, 0]  # [R, C, P]
    return out.transpose(1, 2) if chan else out[:, 0]


def draw_point_candidates(key, rows: int, cfg: TrainConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """PointRend's draws: candidates [R, P * oversample, 2] and the random
    points [R, P - int(importance * P), 2] (``uncertainty_point_coords``'s
    ``split(rng)``)."""
    r1, r2 = key.split(2)
    n_sampled = int(cfg.num_points * cfg.oversample_ratio)
    k_rand = cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points)
    return r1.uniform((rows, n_sampled, 2)), r2.uniform((rows, k_rand, 2))


def uncertainty_point_coords(mask_logits: torch.Tensor, cfg: TrainConfig, key,
                             sh: Optional[BatchShard] = None) -> torch.Tensor:
    """PointRend importance sampling (detectron2
    get_uncertain_point_coords_with_randomness): mask_logits [R, H, W] ->
    coords [R, P, 2], the int(importance * P) candidates of least |logit|
    (stable descending sort of -|v|), then the random points.  No gradient.
    With a shard, the rows (row-major over its videos) take their slice
    of the global batch's draws."""
    R = mask_logits.shape[0]
    dev = mask_logits.device
    if _FIXED_LOSS_COORDS is not None:
        return torch.as_tensor(_FIXED_LOSS_COORDS(R, cfg.num_points), dtype=torch.float32,
                               device=dev)
    if sh is None or not sh.distributed:
        draws = draw_point_candidates(key, R, cfg)
    else:
        draws = (sh.rows(x) for x in draw_point_candidates(key, sh.rows_total(R), cfg))
    cand, rand = (x.to(dev) for x in draws)
    k_unc = int(cfg.importance_sample_ratio * cfg.num_points)
    with torch.no_grad():
        vals = point_sample_rows(mask_logits, cand)
        idx = torch.sort(-vals.abs(), dim=1, descending=True, stable=True).indices[:, :k_unc]
    picked = torch.gather(cand, 1, idx[..., None].expand(R, k_unc, 2))
    return torch.cat([picked, rand], dim=1)


def _sample_mask_points(key, src_masks, tgt_masks, cfg: TrainConfig, sh: BatchShard):
    """src [R, H, W] / tgt [R, Hg, Wg] -> (logits [R, P], labels [R, P])."""
    coords = uncertainty_point_coords(src_masks.detach(), cfg, key, sh)
    with torch.no_grad():
        labels = point_sample_rows(tgt_masks, coords)
    return point_sample_rows(src_masks, coords), labels


# ---------------------------------------------------------------------------
# matcher (video_matcher.py:98-202)
# ---------------------------------------------------------------------------


def match_cost(pred_logits: torch.Tensor, pred_masks: torch.Tensor, labels: torch.Tensor,
               gt_masks: torch.Tensor, coords: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """One video's matching cost [N, Q] (targets x queries): the class
    cost -softmax(5 * sigmoid(logits))[label], the mask BCE and dice
    costs at the shared points ``coords`` [P, 2]."""
    with torch.no_grad():
        Q, N = pred_masks.shape[0], labels.shape[0]
        prob = torch.softmax(torch.sigmoid(pred_logits.to(torch.float32)) * 5.0, dim=-1)
        lbl = (labels.long() - 1).clamp(0, prob.shape[-1] - 1)
        cost_class = -prob[:, lbl]  # [Q, N]
        # [Q, P, T] flattened point-major, as the JAX law
        sm = point_sample_rows(pred_masks, coords[None].expand(Q, -1, -1)).reshape(Q, -1)
        tm = point_sample_rows(gt_masks, coords[None].expand(N, -1, -1)).reshape(N, -1)
        P = sm.shape[1]
        cost_mask = (-F.logsigmoid(sm) @ tm.T + -F.logsigmoid(-sm) @ (1 - tm).T) / P
        sp = torch.sigmoid(sm)
        num = 2 * (sp @ tm.T)
        den = sp.sum(-1)[:, None] + tm.sum(-1)[None, :]
        cost_dice = 1 - (num + 1) / (den + 1)
        C = (cfg.mask_weight_matcher * cost_mask + cfg.dice_weight_matcher * cost_dice
             + cfg.class_weight_matcher * cost_class)
        return C.T


def match_coords(key, P: int, device) -> torch.Tensor:
    """The matcher's shared point set [P, 2] of one video (video_matcher.py:166)."""
    if _FIXED_MATCH_COORDS is not None:
        return torch.as_tensor(_FIXED_MATCH_COORDS, dtype=torch.float32, device=device)
    return key.uniform((P, 2)).to(device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, Q, ...], idx [B, N] -> x[b, idx[b]] [B, N, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


# ---------------------------------------------------------------------------
# per-layer losses
# ---------------------------------------------------------------------------


def _layer_losses_learnable(key, pred_logits, pred_masks, pred_embds, targets: TrainTargets,
                            cls_valid, num_masks, cfg: TrainConfig, task: str,
                            match: torch.Tensor, class_loss: bool = True, boxvis: bool = False,
                            pseudo=None, sh: Optional[BatchShard] = None) -> Dict[str, torch.Tensor]:
    """The learnable queries' losses given their match [B, N] (query per
    target): focal + CE on the matched class rows, BCE + dice at the
    PointRend points (BoxVIS: the box-projection loss, and with the
    teacher's ``pseudo`` (masks [B, N, T, H, W], scores [B, N]) BCE +
    dice on the confident pseudo masks, JAX ``criterion.py:330-357``),
    the ReID contrastive pair."""
    B, Ql, K = pred_logits.shape
    T = pred_masks.shape[2]
    N = targets.labels.shape[1]
    f32 = torch.float32
    sh = sh or BatchShard.whole(B)
    _, r_pts = key.split(2)
    mclip = match.clamp(min=0)
    valid_f = targets.valid.to(f32)
    losses: Dict[str, torch.Tensor] = {}

    if task != "grounding" and class_loss:
        lbl0 = (targets.labels.long() - 1).clamp(0, K - 1)
        # the JAX law's .at[q, label].max(valid): 1 where a valid target lands
        bi = torch.arange(B, device=pred_logits.device)[:, None].expand(B, N)
        hits = torch.zeros((B, Ql, K), dtype=f32, device=pred_logits.device)
        onehot = (hits.index_put((bi, mclip, lbl0), valid_f, accumulate=True) > 0).to(f32)
        logits32 = pred_logits.to(f32)
        focal = torch.stack([focal_conf_sigmoid(logits32[b], onehot[b], cls_valid.to(f32))
                             for b in range(B)])  # [B, Ql]
        n_valid_b = targets.valid.sum(-1).to(f32)
        loss_focal_b = focal.sum(-1) / n_valid_b.clamp(min=1)
        matched = _take(logits32, mclip)  # [B, N, K]
        logZ = torch.logsumexp(torch.where(cls_valid[None, None, :], matched,
                                           torch.full_like(matched, -1e9)), dim=-1)
        ce = logZ - torch.gather(matched, -1, lbl0[..., None])[..., 0]
        loss_ce_b = (ce * valid_f).sum(-1) / n_valid_b.clamp(min=1)
        w = n_valid_b / sh.count(n_valid_b.sum()).clamp(min=1)
        losses["loss_ce"] = ((loss_focal_b + loss_ce_b) * w).sum()

    src = _take(pred_masks, mclip).reshape(B * N * T, *pred_masks.shape[-2:])
    tgt = targets.masks.reshape(B * N * T, *targets.masks.shape[-2:])
    row_valid = valid_f.reshape(-1).repeat_interleave(T)
    if boxvis:
        # box-region targets: the projection loss (video_criterion.py:618-652);
        # with the teacher, BCE + dice on the confident pseudo masks
        # (mask2former criterion.py:526-570, gated at pseudo_score_thresh)
        losses.update(loss_masks_box_supervised(src, tgt, row_valid, num_masks))
        if pseudo is not None:
            pm, ps = pseudo
            gate = (ps > cfg.pseudo_score_thresh) & targets.valid
            row_gate = gate.reshape(-1).repeat_interleave(T).to(f32)
            n_hc = sh.count(gate.sum()).clamp(min=1).to(f32) * T
            logits, labels_pt = _sample_mask_points(
                r_pts, src, pm.reshape(B * N * T, *pm.shape[-2:]), cfg, sh)
            losses["loss_mask"] = (sigmoid_ce_points(logits, labels_pt) * row_gate).sum() / n_hc
            losses["loss_dice"] = (dice_loss_points(logits, labels_pt) * row_gate).sum() / n_hc
    else:
        logits, labels_pt = _sample_mask_points(r_pts, src, tgt, cfg, sh)
        losses["loss_mask"] = (sigmoid_ce_points(logits, labels_pt) * row_valid).sum() / num_masks
        losses["loss_dice"] = (dice_loss_points(logits, labels_pt) * row_valid).sum() / num_masks

    embds = _take(pred_embds, mclip).to(f32)  # [B, N, T, C]
    C = embds.shape[-1]
    flat = embds.reshape(B * N * T, C)
    ids = targets.ids.reshape(-1)
    vids = sh.offset + torch.arange(B, device=flat.device).repeat_interleave(N * T)
    keep = (ids >= 0) & targets.valid.reshape(-1).repeat_interleave(T)
    cols, ids_c, vids_c, keep_c = (sh.columns(x) for x in (flat, ids, vids, keep))
    sim = flat @ cols.T / math.sqrt(C)
    pos = ((ids[:, None] == ids_c[None]) & (vids[:, None] == vids_c[None])).to(f32)
    losses["loss_reid"] = contrastive_loss(sim, pos, keep, keep_c,
                                           gumbel=draw_gumbel_pair(key.fold_in(101), sim.shape[1]),
                                           count=sh.count)
    nrm = _unit(flat)
    losses["loss_reid_aux"] = contrastive_aux_loss(nrm @ sh.columns(nrm).T, pos, keep, keep_c,
                                                   count=sh.count)
    return losses


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def _layer_losses_prompt(key, pred_logits, pred_masks, pred_embds, targets: TrainTargets,
                         cls_valid, num_masks, cfg: TrainConfig, task: str,
                         class_loss: bool = True, text_detection: bool = False,
                         sh: Optional[BatchShard] = None) -> Dict[str, torch.Tensor]:
    """Fixed assignment: prompt slot i is bound to target
    prompt_obj_ids[i] (video_criterion_prompt.py); text detection binds
    the slots to the semantic targets."""
    B, Qp, K = pred_logits.shape
    T = pred_masks.shape[2]
    f32 = torch.float32
    poi = targets.prompt_obj_ids.long()
    pvalid = poi >= 0
    pclip = poi.clamp(min=0)
    sh = sh or BatchShard.whole(B)
    r_pts, _ = key.split(2)
    use_sem = text_detection and targets.sem_masks is not None
    tgt_labels_all = targets.sem_labels if use_sem else targets.labels
    tgt_masks_all = targets.sem_masks if use_sem else targets.masks
    pvalid_f = pvalid.to(f32)
    losses: Dict[str, torch.Tensor] = {}

    if task != "grounding" and class_loss:
        lbl = torch.gather(tgt_labels_all.long(), 1, pclip)
        lbl0 = (lbl - 1).clamp(0, K - 1)
        oh = F.one_hot(lbl0, K).to(f32) * pvalid_f[..., None]
        logits32 = pred_logits.to(f32)
        focal = torch.stack([focal_conf_sigmoid(logits32[b], oh[b], cls_valid.to(f32))
                             for b in range(B)])
        nb = pvalid.sum(-1).to(f32)
        loss_focal_b = focal.sum(-1) / nb.clamp(min=1)
        logZ = torch.logsumexp(torch.where(cls_valid[None, None, :], logits32,
                                           torch.full_like(logits32, -1e9)), dim=-1)
        ce = logZ - torch.gather(logits32, -1, lbl0[..., None])[..., 0]
        loss_ce_b = (ce * pvalid_f).sum(-1) / nb.clamp(min=1)
        w = nb / sh.count(nb.sum()).clamp(min=1)
        losses["loss_ce"] = ((loss_focal_b + loss_ce_b) * w).sum()

    src = pred_masks.reshape(B * Qp * T, *pred_masks.shape[-2:])
    tgt = _take(tgt_masks_all, pclip).reshape(B * Qp * T, *tgt_masks_all.shape[-2:])
    logits, labels_pt = _sample_mask_points(r_pts, src, tgt, cfg, sh)
    row_valid = pvalid_f.reshape(-1).repeat_interleave(T)
    losses["loss_mask"] = (sigmoid_ce_points(logits, labels_pt) * row_valid).sum() / num_masks
    losses["loss_dice"] = (dice_loss_points(logits, labels_pt) * row_valid).sum() / num_masks

    C = pred_embds.shape[-1]
    flat = pred_embds.to(f32).reshape(B * Qp * T, C)
    ids = poi.reshape(-1).repeat_interleave(T)
    vids = sh.offset + torch.arange(B, device=flat.device).repeat_interleave(Qp * T)
    keep = ids >= 0
    cols, ids_c, vids_c, keep_c = (sh.columns(x) for x in (flat, ids, vids, keep))
    sim = flat @ cols.T / math.sqrt(C)
    pos = ((ids[:, None] == ids_c[None]) & (vids[:, None] == vids_c[None])).to(f32)
    losses["loss_reid"] = contrastive_loss(sim, pos, keep, keep_c,
                                           gumbel=draw_gumbel_pair(key.fold_in(101), sim.shape[1]),
                                           count=sh.count)
    nrm = _unit(flat)
    losses["loss_reid_aux"] = contrastive_aux_loss(nrm @ sh.columns(nrm).T, pos, keep, keep_c,
                                                   count=sh.count)
    return losses


def _resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[R, Hg, Wg] -> [R, h, w] as ``jax.image.resize(..., "nearest")``:
    source index floor((i + 0.5) * in / out) in float32 (half-pixel
    centres), an axis of equal size untouched."""
    def index(n_out, n_in):
        o = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out
        return torch.floor(o).long()

    if x.shape[-2] != h:
        x = x[:, index(h, x.shape[-2])]
    if x.shape[-1] != w:
        x = x[:, :, index(w, x.shape[-1])]
    return x


def loss_masks_box_supervised(pred_masks: torch.Tensor, gt_boxes_masks: torch.Tensor,
                              valid: torch.Tensor, num_masks) -> Dict[str, torch.Tensor]:
    """BoxVIS projection loss (video_criterion.py:618-652): dice between
    the x and y max-projections of each predicted mask [R, H, W] (logits,
    sigmoid in their dtype) and of its box-region mask [R, Hg, Wg]
    (nearest-resized to the prediction), summed over the valid rows [R]
    / ``num_masks``."""
    p = torch.sigmoid(pred_masks)
    g = _resize_nearest(gt_boxes_masks.to(torch.float32), *p.shape[1:])

    def proj_dice(a, b):  # [R, L] soft projections
        num = 2 * (a * b).sum(-1)
        den = (a * a).sum(-1) + (b * b).sum(-1)
        return 1 - num / den.clamp(min=1e-6)

    py = proj_dice(p.amax(dim=-1), g.amax(dim=-1))
    px = proj_dice(p.amax(dim=-2), g.amax(dim=-2))
    return {"loss_mask_proj": ((px + py) * valid).sum() / num_masks}


def boxvis_teacher_pseudo_masks(key, teacher_logits: torch.Tensor, teacher_masks: torch.Tensor,
                                targets: TrainTargets, cls_valid: torch.Tensor, cfg: TrainConfig,
                                sh: Optional[BatchShard] = None):
    """The EMA teacher's pseudo masks for box-supervised training
    (``BoxVISTeacherSetPseudoMask``, video_criterion.py:242-306): the
    teacher's learnable queries ([B, Ql, K] logits, [B, Ql, T, H, W]
    masks) Hungarian-matched to the box targets (one ``split(key, B)``
    key a video, one host copy of the costs); per target the pseudo mask
    box x sigmoid(matched teacher mask) and its confidence teacher class
    prob x 0.5 (px + py), the dice coefficients of the x / y
    max-projections (flattened over the frames) of the teacher mask and
    the box mask.  Returns (pseudo masks [B, N, T, H, W] in [0, 1],
    scores [B, N]), without gradient."""
    with torch.no_grad():
        B, Ql, K = teacher_logits.shape
        sh = sh or BatchShard.whole(B)
        vkeys = sh.split(key)
        costs = torch.stack([
            match_cost(teacher_logits[b], teacher_masks[b], targets.labels[b], targets.masks[b],
                       match_coords(vkeys[b], cfg.num_points, targets.masks.device), cfg)
            for b in range(B)])
        match = hungarian_batch(costs, targets.valid)  # [B, N]
        mclip = match.clamp(min=0)
        soft = torch.sigmoid(_take(teacher_masks.to(torch.float32), mclip))  # [B, N, T, H, W]
        prob = torch.softmax(torch.where(cls_valid[None, None, :],
                                         teacher_logits.to(torch.float32),
                                         torch.full_like(teacher_logits, -1e9,
                                                         dtype=torch.float32)), dim=-1)
        lbl0 = (targets.labels.long() - 1).clamp(0, K - 1)
        cls_score = torch.gather(_take(prob, mclip), -1, lbl0[..., None])[..., 0]  # [B, N]
        box = targets.masks.to(torch.float32)
        N = match.shape[1]

        def proj_score(a, b):  # [B, N, L] soft projections, the dice COEFFICIENT
            num = 2 * (a * b).sum(-1)
            den = (a * a).sum(-1) + (b * b).sum(-1)
            return num / den.clamp(min=1e-6)

        py = proj_score(soft.amax(dim=-2).reshape(B, N, -1), box.amax(dim=-2).reshape(B, N, -1))
        px = proj_score(soft.amax(dim=-1).reshape(B, N, -1), box.amax(dim=-1).reshape(B, N, -1))
        scores = cls_score * 0.5 * (px + py) * targets.valid.to(torch.float32)
        return box * soft, scores


def loss_masks_sem(key, pred_masks_p: torch.Tensor, targets: TrainTargets,
                   cfg: TrainConfig, sh: Optional[BatchShard] = None) -> torch.Tensor:
    """Semantic cross-entropy over the prompt slots at sampled points
    (video_criterion_prompt.py:489-541): per pixel the slot owning it
    (argmax over slots, first on ties), background ignored; owner and
    foreground read at the points with NEAREST semantics (:524)."""
    B, Qp, T, H, W = pred_masks_p.shape
    f32 = torch.float32
    sh = sh or BatchShard.whole(B)
    poi = targets.prompt_obj_ids.long()
    pvalid = poi >= 0
    gt_src = targets.sem_masks if targets.sem_masks is not None else targets.masks
    gt = _take(gt_src, poi.clamp(min=0)) * pvalid[:, :, None, None, None].to(gt_src.dtype)
    owner = torch.argmax(gt, dim=1)  # [B, T, h, w]
    has_fg = gt.amax(dim=1) > 0
    src = pred_masks_p.transpose(1, 2).reshape(B * T, Qp, H, W)
    coords = uncertainty_point_coords(src.detach().amax(dim=1), cfg, key, sh)  # [BT, P, 2]
    logits_pt = point_sample_rows(src, coords)  # [BT, P, Qp]
    h, w = owner.shape[-2:]
    ix = torch.round(coords[..., 0] * w - 0.5).long().clamp(0, w - 1)
    iy = torch.round(coords[..., 1] * h - 0.5).long().clamp(0, h - 1)
    bt = torch.arange(B * T, device=src.device)[:, None]
    lab = owner.reshape(B * T, h, w)[bt, iy, ix]
    keep = has_fg.reshape(B * T, h, w)[bt, iy, ix].to(f32)
    logZ = torch.logsumexp(logits_pt, dim=-1)
    ce = logZ - torch.gather(logits_pt, -1, lab[..., None])[..., 0]
    return (ce * keep).sum() / sh.count(keep.sum()).clamp(min=1.0)


def loss_l2v_attn_weights(key, l2v: torch.Tensor, level_sizes, tokens_per_prompt: int,
                          targets: TrainTargets, cfg: TrainConfig, t: int,
                          num_masks, sh: Optional[BatchShard] = None) -> Dict[str, torch.Tensor]:
    """Lang->vision attention supervision (video_criterion_prompt.py:
    543-598): smooth-L1 + dice between the max-normalized sentence-token
    attention maps ([B*T, Qp*L, S], head-averaged) and the GT masks at
    sampled points, one loss per level ``loss_l2v_attn_weight_{i}``."""
    f32 = torch.float32
    BT = l2v.shape[0]
    B = BT // t
    sh = sh or BatchShard.whole(B)
    Qp = l2v.shape[1] // tokens_per_prompt
    w = l2v.to(f32).reshape(BT, Qp, tokens_per_prompt, -1)[:, :, 0]  # [BT, Qp, S]
    w = w / w.amax(-1, keepdim=True).clamp(min=1e-6)
    poi = targets.prompt_obj_ids.long()
    valid = (poi >= 0).to(f32).reshape(-1).repeat_interleave(t)
    gt = _take(targets.masks, poi.clamp(min=0))  # [B, Qp, T, h, w]
    out: Dict[str, torch.Tensor] = {}
    start = 0
    for li, (h, wd) in enumerate(level_sizes):
        maps = w[:, :, start:start + h * wd].reshape(B, t, Qp, h, wd).transpose(1, 2)
        start += h * wd
        src = maps.reshape(B * Qp * t, h, wd)
        tgt = gt.reshape(B * Qp * t, *gt.shape[-2:])
        coords = uncertainty_point_coords((0.9 - src).detach(), cfg, key.fold_in(li), sh)
        probs = point_sample_rows(src, coords)
        with torch.no_grad():
            labels = point_sample_rows(tgt, coords)
        d = (probs - labels).abs()
        sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        n_fg = sh.count((labels * valid[:, None]).sum())
        sl1 = (sl1 * valid[:, None]).sum() / n_fg.clamp(min=1.0)
        dice = (dice_loss_points(probs, labels, already_prob=True) * valid).sum() / num_masks
        out[f"loss_l2v_attn_weight_{li}"] = 0.5 * (sl1 + dice)
    return out


def _loss_reid_l2p(key, pred_embds_l, match, pred_embds_p, targets: TrainTargets,
                   text_detection: bool = False,
                   sh: Optional[BatchShard] = None) -> Dict[str, torch.Tensor]:
    """Learnable <-> prompt alignment (video_criterion.py:480-568).  Text
    detection: positives share the CLASS label, no aux loss; sot and
    grounding: positives share the per-frame TRACK id, absent frames
    dropped on both sides."""
    f32 = torch.float32
    B, N = match.shape
    T = pred_embds_l.shape[2]
    C = pred_embds_l.shape[-1]
    sh = sh or BatchShard.whole(B)
    mclip = match.clamp(min=0)
    src = _take(pred_embds_l, mclip).to(f32).reshape(B * N * T, C)
    vids_l = sh.offset + torch.arange(B, device=src.device).repeat_interleave(N * T)
    Qp = pred_embds_p.shape[1]
    poi = targets.prompt_obj_ids.long()
    prm = pred_embds_p.to(f32).reshape(B * Qp * T, C)
    vids_p = sh.offset + torch.arange(B, device=src.device).repeat_interleave(Qp * T)
    matched_valid = (targets.valid & (match >= 0)).reshape(-1).repeat_interleave(T)
    if text_detection:
        ids_l = targets.labels.reshape(-1).repeat_interleave(T)
        keep_l = (ids_l >= 1) & matched_valid
        lab_src = targets.sem_labels if targets.sem_labels is not None else targets.labels
        ids_p = torch.gather(lab_src.long(), 1, poi.clamp(min=0)).reshape(-1).repeat_interleave(T)
        keep_p = (poi >= 0).reshape(-1).repeat_interleave(T)
    else:
        ids_l = targets.ids.reshape(-1)
        keep_l = (ids_l >= 0) & matched_valid
        ids_p3 = _take(targets.ids, poi.clamp(min=0))  # [B, Qp, T]
        ids_p = torch.where((poi >= 0)[..., None], ids_p3, torch.full_like(ids_p3, -1)).reshape(-1)
        keep_p = ids_p >= 0
    cols, ids_c, vids_c, keep_c = (sh.columns(x) for x in (prm, ids_p, vids_p, keep_p))
    sim = src @ cols.T / math.sqrt(C)
    pos = ((ids_l[:, None] == ids_c[None]) & (vids_l[:, None] == vids_c[None])).to(f32)
    out = {"loss_reid_l2p": contrastive_loss(sim, pos, keep_l, keep_c,
                                             gumbel=draw_gumbel_pair(key.fold_in(103),
                                                                     sim.shape[1]),
                                             count=sh.count)}
    if text_detection:
        out["loss_reid_l2p_aux"] = torch.zeros((), dtype=f32, device=src.device)
    else:
        out["loss_reid_l2p_aux"] = contrastive_aux_loss(_unit(src) @ sh.columns(_unit(prm)).T,
                                                        pos, keep_l, keep_c, count=sh.count)
    return out


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


class UniCriterion:
    """outputs (the decoder's dict) + targets -> (total, logged losses).
    The weighted sum takes the reference weight_dict: loss_ce x
    class_weight, loss_mask x mask_weight, loss_dice x dice_weight,
    loss_reid* x reid_weight, on the final layer and every aux layer;
    ``last_matches`` keeps the step's assignments [layers, B, N]."""

    def __init__(self, cfg: TrainConfig, num_learnable: int, num_frames: int):
        self.cfg = cfg
        self.num_learnable = num_learnable
        self.num_frames = num_frames
        self.last_matches: Optional[torch.Tensor] = None

    def weight(self, name: str) -> float:
        c = self.cfg
        if name.startswith("loss_ce"):
            return c.class_weight
        if name.startswith("loss_mask"):
            return c.mask_weight
        if name.startswith("loss_dice"):
            return c.dice_weight
        if name.startswith("loss_reid"):
            return c.reid_weight
        return 1.0

    def match(self, key, layers: List[Dict], targets: TrainTargets,
              sh: Optional[BatchShard] = None) -> torch.Tensor:
        """Every layer's and video's Hungarian match [L, B, N] from one host
        copy of the costs (the draws of each layer's ``r_match``)."""
        Ql = self.num_learnable
        B = targets.labels.shape[0]
        sh = sh or BatchShard.whole(B)
        costs = []
        for li, layer in enumerate(layers):
            r_l, _ = key.fold_in(li).split(2)
            r_match, _ = r_l.split(2)
            vkeys = sh.split(r_match)
            costs.append(torch.stack([
                match_cost(layer["pred_logits"][b, :Ql], layer["pred_masks"][b, :Ql],
                           targets.labels[b], targets.masks[b],
                           match_coords(vkeys[b], self.cfg.num_points, targets.masks.device),
                           self.cfg)
                for b in range(B)]))
        return hungarian_batch(torch.stack(costs), targets.valid[None].expand(len(layers), -1, -1))

    def __call__(self, key, outputs: Dict, targets: TrainTargets, cls_valid: torch.Tensor,
                 task: str = "detection", learnable_enabled: bool = True,
                 class_loss: bool = True, sem_loss: bool = False, level_sizes=None,
                 tokens_per_prompt: int = 1, boxvis: bool = False, pseudo=None,
                 prompt_type: str = "text", reid_stash: Optional[list] = None,
                 shard: Optional[BatchShard] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``boxvis``: the box-supervised mask losses, with the EMA
        teacher's ``pseudo`` (masks, scores) when given.  ``reid_stash``:
        a list the caller owns; one (matched embeddings [B, N, T, C],
        their per-frame ids [B, N, T], -1 for invalid targets) is
        appended per decoder layer, the stage-3 inter-clip stash
        (video_criterion.py:473-477).  ``shard``: this process's videos
        of the global batch (data parallelism); None, the whole batch."""
        Ql = self.num_learnable
        T = self.num_frames
        f32 = torch.float32
        B = targets.labels.shape[0]
        sh = shard or BatchShard.whole(B)
        num_masks = sh.count(targets.valid.sum()).clamp(min=1).to(f32) * T
        has_prompt = outputs["pred_masks"].shape[1] > Ql
        Qp = outputs["pred_masks"].shape[1] - Ql
        # the prompt normalizer counts every prompt slot of the global batch
        # (video_criterion_prompt.py:617-624)
        num_masks_p = torch.tensor(float(max(sh.total * Qp, 1) * T), dtype=f32,
                                   device=targets.masks.device)
        text_detection = task == "detection" and prompt_type == "text"
        layers = outputs["aux_outputs"] + [outputs]
        matches = self.match(key, layers, targets, sh) if learnable_enabled else None
        self.last_matches = matches
        total = torch.zeros((), dtype=f32, device=targets.masks.device)
        logged: Dict[str, torch.Tensor] = {}
        for li, layer in enumerate(layers):
            r = key.fold_in(li)
            r_l, r_p = r.split(2)
            suffix = "" if li == len(layers) - 1 else f"_{li}"
            merged: Dict[str, torch.Tensor] = {}
            if learnable_enabled:
                merged.update(_layer_losses_learnable(
                    r_l, layer["pred_logits"][:, :Ql], layer["pred_masks"][:, :Ql],
                    layer["pred_embds"][:, :Ql], targets, cls_valid, num_masks, self.cfg, task,
                    matches[li], class_loss, boxvis=boxvis, pseudo=pseudo, sh=sh))
                if reid_stash is not None:
                    ids = torch.where(targets.valid[:, :, None], targets.ids,
                                      torch.full_like(targets.ids, -1))
                    reid_stash.append((_take(layer["pred_embds"][:, :Ql], matches[li]), ids))
            if has_prompt:
                lp = _layer_losses_prompt(
                    r_p, layer["pred_logits"][:, Ql:], layer["pred_masks"][:, Ql:],
                    layer["pred_embds"][:, Ql:], targets, cls_valid, num_masks_p, self.cfg, task,
                    class_loss, text_detection=text_detection, sh=sh)
                if sem_loss and text_detection:
                    lp["loss_mask"] = lp["loss_mask"] + loss_masks_sem(
                        r.fold_in(777), layer["pred_masks"][:, Ql:], targets, self.cfg, sh)
                for k, v in lp.items():
                    merged[k] = 0.5 * (merged[k] + v) if k in merged else v
                if matches is not None:
                    merged.update(_loss_reid_l2p(
                        r.fold_in(555), layer["pred_embds"][:, :Ql], matches[li],
                        layer["pred_embds"][:, Ql:], targets, text_detection=text_detection,
                        sh=sh))
            for k, v in merged.items():
                logged[k + suffix] = v
                total = total + self.weight(k) * v
        if (outputs.get("l2v_attn_weights") is not None and level_sizes is not None
                and task == "grounding"):
            l2v = loss_l2v_attn_weights(key.fold_in(999), outputs["l2v_attn_weights"],
                                        level_sizes, tokens_per_prompt, targets, self.cfg, T,
                                        num_masks_p, sh)
            for k, v in l2v.items():
                logged[k] = v
                total = total + self.cfg.mask_weight * v
        return total, logged
