"""Video Panoptic Quality (VPQ) for VPS (the port's copy of
``univs_tpu/evaluation/vpq.py``, which the port may not import).

Standalone numpy rebuild of the reference's VIPSeg evaluation
(reference: univs/evaluation/eval_vpq_vps.py:77-312 — per-{1,2,4,6}-
frame tube PQ: segments are matched by IoU > 0.5 over the
concatenated-tube pixels; PQ = sum(TP IoU) / (TP + FP/2 + FN/2),
averaged over categories then over spans).

Void/crowd laws (eval_vpq_vps.py:184-232):

- crowd GT segments never match and are not FNs; instead they are
  recorded per category (last one wins, :209-215);
- the match union is reduced by the prediction's intersection with
  VOID (id 0) — "remove background area" (:196);
- an unmatched prediction is DROPPED (not an FP) when more than half
  of its tube area intersects VOID plus the same-category crowd
  segment (:220-232).

Inputs are per-frame (segment_id, category) panoptic maps; pixels with
segment id 0 are VOID.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

VOID = 0


def _tube_stats(gt_seg: np.ndarray, gt_cat: Dict[int, int],
                pr_seg: np.ndarray, pr_cat: Dict[int, int],
                num_classes: int,
                gt_crowd: Dict[int, bool]):
    """One tube (stacked frames). Returns per-class (iou_sum, tp, fp, fn)."""
    iou_sum = np.zeros(num_classes)
    tp = np.zeros(num_classes, np.int64)
    fp = np.zeros(num_classes, np.int64)
    fn = np.zeros(num_classes, np.int64)

    gt_ids, gt_areas = np.unique(gt_seg, return_counts=True)
    pr_ids, pr_areas = np.unique(pr_seg, return_counts=True)
    gt_area = dict(zip(gt_ids.tolist(), gt_areas.tolist()))
    pr_area = dict(zip(pr_ids.tolist(), pr_areas.tolist()))

    # pair intersections via combined key
    comb = gt_seg.astype(np.int64) * (2 ** 32) + pr_seg.astype(np.int64)
    pairs, pair_areas = np.unique(comb, return_counts=True)
    inter = {}
    for key, a in zip(pairs.tolist(), pair_areas.tolist()):
        inter[(key >> 32, key & 0xFFFFFFFF)] = a

    matched_gt, matched_pr = set(), set()
    for (gi, pi), a in inter.items():
        if gi == VOID or pi == VOID:
            continue
        if gi not in gt_cat or pi not in pr_cat:
            continue
        if gt_crowd.get(gi, False):
            # crowd GT segments are ignored in matching (ref :184-185)
            continue
        if gt_cat[gi] != pr_cat[pi]:
            continue
        # union with the pred's VOID overlap removed (ref :196)
        union = gt_area[gi] + pr_area[pi] - a - inter.get((VOID, pi), 0)
        iou = a / union if union > 0 else 0.0
        if iou > 0.5:
            c = gt_cat[gi]
            iou_sum[c] += iou
            tp[c] += 1
            matched_gt.add(gi)
            matched_pr.add(pi)

    # unmatched GT: crowd segments become per-category ignore regions
    # instead of FNs (ref :209-215; last crowd label per category wins)
    crowd_by_cat: Dict[int, int] = {}
    for gi, c in gt_cat.items():
        if gi == VOID or gi not in gt_area or gi in matched_gt:
            continue
        if gt_crowd.get(gi, False):
            crowd_by_cat[c] = gi
            continue
        fn[c] += 1

    # unmatched predictions: dropped when >50% of their area lies in
    # VOID + the same-category crowd segment (ref :220-232)
    for pi, c in pr_cat.items():
        if pi == VOID or pi not in pr_area or pi in matched_pr:
            continue
        ignore = inter.get((VOID, pi), 0)
        if c in crowd_by_cat:
            ignore += inter.get((crowd_by_cat[c], pi), 0)
        if ignore / pr_area[pi] > 0.5:
            continue
        fp[c] += 1
    return iou_sum, tp, fp, fn


def vpq_single_video(
    gt_segs: Sequence[np.ndarray],  # per-frame segment-id maps
    gt_cats: Dict[int, int],  # segment id -> category
    pr_segs: Sequence[np.ndarray],
    pr_cats: Dict[int, int],
    num_classes: int,
    spans: Sequence[int] = (1, 2, 4, 6),
    gt_crowd: Dict[int, bool] | None = None,
) -> Dict[str, float]:
    """VPQ over tube spans; returns {'vpq': mean, 'vpq_k': per span}."""
    T = len(gt_segs)
    gt_crowd = gt_crowd or {}
    results = {}
    vals = []
    for k in spans:
        iou_sum = np.zeros(num_classes)
        tp = np.zeros(num_classes, np.int64)
        fp = np.zeros(num_classes, np.int64)
        fn = np.zeros(num_classes, np.int64)
        for s in range(T - k + 1):
            g = np.stack(gt_segs[s : s + k]).reshape(-1)
            p = np.stack(pr_segs[s : s + k]).reshape(-1)
            i, t_, f_, n_ = _tube_stats(g, gt_cats, p, pr_cats, num_classes,
                                        gt_crowd)
            iou_sum += i
            tp += t_
            fp += f_
            fn += n_
        denom = tp + fp / 2 + fn / 2
        present = denom > 0
        pq_c = np.where(present, iou_sum / np.maximum(denom, 1e-9), np.nan)
        vpq_k = float(np.nanmean(np.where(present, pq_c, np.nan))) if present.any() else 0.0
        results[f"vpq_{k}"] = vpq_k
        vals.append(vpq_k)
    results["vpq"] = float(np.mean(vals))
    return results
