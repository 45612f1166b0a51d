"""YouTube-VIS video-AP evaluator (COCO-style, RLE videos) (the port's copy of
``univs_tpu/evaluation/ytvis.py``, which the port may not import).

Standalone numpy rebuild of the reference's vendored ytvis_api
(reference: univs/data/datasets/ytvis_api/ytvoseval.py — COCO-style AP
over spatio-temporal mask IoU: per-video IoU = sum_t |inter| /
sum_t |union| over per-frame RLEs, 10 thresholds 0.50:0.05:0.95,
greedy score-ordered matching, 101-point interpolated AP).

Predictions: {"video_id", "category_id", "score", "segmentations":
[RLE or None per frame]}.  Ground truth: {"video_id", "category_id",
"segmentations", "id", optional "iscrowd"}.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from univs_tpu_torch.utils import rle as rle_util

IOU_THRS = np.round(np.arange(0.5, 0.96, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def video_mask_iou(seg_a: Sequence, seg_b: Sequence, iscrowd: bool = False) -> float:
    """Spatio-temporal IoU of two RLE videos (None = empty frame)."""
    inter = 0
    union = 0
    area_a = 0
    for a, b in zip(seg_a, seg_b):
        ia = rle_util.area(a) if a else 0
        ib = rle_util.area(b) if b else 0
        ii = rle_util.intersection(a, b) if (a and b) else 0
        inter += ii
        union += ia + ib - ii
        area_a += ia
    if iscrowd:
        return inter / area_a if area_a > 0 else 0.0
    return inter / union if union > 0 else 0.0


class YTVISEval:
    def __init__(self, gts: List[Dict], preds: List[Dict], max_dets: int = 100):
        self.gts = gts
        self.preds = preds
        self.max_dets = max_dets

    def evaluate(self) -> Dict[str, float]:
        gts_by = defaultdict(list)
        prs_by = defaultdict(list)
        cats = set()
        for g in self.gts:
            gts_by[(g["video_id"], g["category_id"])].append(g)
            cats.add(g["category_id"])
        for p in self.preds:
            prs_by[(p["video_id"], p["category_id"])].append(p)

        videos = sorted({g["video_id"] for g in self.gts} | {p["video_id"] for p in self.preds})

        ap_per_cat = []
        ap50_per_cat = []
        ap75_per_cat = []
        ar_per_cat = []
        for c in sorted(cats):
            scores_all = []
            matched_all = []  # [T_thr, n_det] bool
            ignored_all = []  # [T_thr, n_det] bool — crowd-matched dets
            n_gt = 0
            for v in videos:
                gt = gts_by.get((v, c), [])
                pr = sorted(prs_by.get((v, c), []), key=lambda x: -x["score"])[: self.max_dets]
                n_gt += sum(0 if g.get("iscrowd") else 1 for g in gt)
                if not pr:
                    continue
                ious = np.zeros((len(pr), len(gt)))
                for i, p in enumerate(pr):
                    for j, g in enumerate(gt):
                        ious[i, j] = video_mask_iou(
                            p["segmentations"], g["segmentations"], bool(g.get("iscrowd"))
                        )
                m = np.zeros((len(IOU_THRS), len(pr)), bool)
                ig = np.zeros((len(IOU_THRS), len(pr)), bool)
                # non-crowd GTs first (COCO order); a det whose best
                # match is crowd is IGNORED (neither TP nor FP)
                gt_order = sorted(range(len(gt)), key=lambda j: bool(gt[j].get("iscrowd")))
                for ti, thr in enumerate(IOU_THRS):
                    taken = np.zeros(len(gt), bool)
                    for i in range(len(pr)):
                        best, bj = thr, -1
                        for j in gt_order:
                            crowd = bool(gt[j].get("iscrowd"))
                            if taken[j] and not crowd:
                                continue
                            # already matched a non-crowd GT; remaining
                            # GTs are crowd — keep the real match
                            if bj >= 0 and not gt[bj].get("iscrowd") and crowd:
                                break
                            if ious[i, j] >= best:
                                best, bj = ious[i, j], j
                        if bj >= 0:
                            if gt[bj].get("iscrowd"):
                                ig[ti, i] = True
                            else:
                                m[ti, i] = True
                                taken[bj] = True
                scores_all.extend(p["score"] for p in pr)
                matched_all.append(m)
                ignored_all.append(ig)
            if n_gt == 0:
                continue
            if not scores_all:
                ap_per_cat.append(0.0)
                ap50_per_cat.append(0.0)
                ap75_per_cat.append(0.0)
                ar_per_cat.append(0.0)
                continue
            scores = np.asarray(scores_all)
            matched = np.concatenate(matched_all, axis=1)
            ignored = np.concatenate(ignored_all, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            matched = matched[:, order]
            ignored = ignored[:, order]
            tps = np.cumsum(matched & ~ignored, axis=1)
            fps = np.cumsum(~matched & ~ignored, axis=1)
            rc = tps / n_gt
            pr_ = tps / np.maximum(tps + fps, 1e-9)
            aps = []
            for ti in range(len(IOU_THRS)):
                p_interp = np.maximum.accumulate(pr_[ti][::-1])[::-1]
                idx = np.searchsorted(rc[ti], RECALL_THRS, side="left")
                prec = np.where(idx < len(p_interp), p_interp[np.clip(idx, 0, len(p_interp) - 1)], 0.0)
                aps.append(prec.mean())
            ap_per_cat.append(float(np.mean(aps)))
            ap50_per_cat.append(float(aps[0]))
            ap75_per_cat.append(float(aps[5]))
            ar_per_cat.append(float(rc[:, -1].mean()))

        if not ap_per_cat:
            return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "AR100": 0.0}
        return {
            "AP": float(np.mean(ap_per_cat)),
            "AP50": float(np.mean(ap50_per_cat)),
            "AP75": float(np.mean(ap75_per_cat)),
            "AR100": float(np.mean(ar_per_cat)),
        }
