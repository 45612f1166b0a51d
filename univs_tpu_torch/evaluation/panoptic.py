"""Panoptic Quality (PQ) — numpy implementation of the panopticapi (the port's copy of
``univs_tpu/evaluation/panoptic.py``, which the port may not import).
evaluation law used by the reference's COCOPanopticEvaluator
(reference: train_net.py:111-165 dispatches evaluator_type
'coco_panoptic_seg' to detectron2's COCOPanopticEvaluator, which wraps
panopticapi.pq_compute).

Standard law: segments match iff same category and IoU > 0.5 where
IoU = inter / (gt_area + pred_area - inter - pred∩VOID); unmatched
predictions whose (VOID + unmatched-crowd) overlap fraction exceeds 0.5
are ignored rather than counted FP.  PQ = Σ IoU / (TP + FP/2 + FN/2).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

VOID = 0
_OFFSET = 256 * 256 * 256


class PQStat:
    """Per-class TP/FP/FN/IoU accumulator over a dataset."""

    def __init__(self):
        self.iou_sum: Dict[int, float] = {}
        self.tp: Dict[int, int] = {}
        self.fp: Dict[int, int] = {}
        self.fn: Dict[int, int] = {}

    def _bump(self, d, c, v=1):
        d[c] = d.get(c, 0) + v

    def update(
        self,
        gt_pan: np.ndarray,  # [H, W] segment ids (0 = void/unlabeled)
        gt_segments: List[Dict],  # {id, category_id, iscrowd?}
        pred_pan: np.ndarray,  # [H, W] segment ids (0 = nothing)
        pred_segments: List[Dict],  # {id, category_id}
    ) -> None:
        gt_info = {s["id"]: s for s in gt_segments}
        pred_info = {s["id"]: s for s in pred_segments}
        gt_areas = {i: int(a) for i, a in zip(*np.unique(gt_pan, return_counts=True))}
        pred_areas = {i: int(a) for i, a in zip(*np.unique(pred_pan, return_counts=True))}

        combined = gt_pan.astype(np.int64) * _OFFSET + pred_pan.astype(np.int64)
        pairs, counts = np.unique(combined, return_counts=True)
        inter: Dict[Tuple[int, int], int] = {}
        for p, c in zip(pairs, counts):
            inter[(int(p // _OFFSET), int(p % _OFFSET))] = int(c)

        matched_gt, matched_pred = set(), set()
        for (gid, pid), i in inter.items():
            if gid == VOID or pid == VOID:
                continue
            if gid not in gt_info or pid not in pred_info:
                continue
            if gt_info[gid].get("iscrowd", 0):
                continue
            if gt_info[gid]["category_id"] != pred_info[pid]["category_id"]:
                continue
            union = (
                gt_areas[gid] + pred_areas[pid] - i
                - inter.get((VOID, pid), 0)
            )
            iou = i / max(union, 1)
            if iou > 0.5:
                c = gt_info[gid]["category_id"]
                self._bump(self.tp, c)
                self._bump(self.iou_sum, c, iou)
                matched_gt.add(gid)
                matched_pred.add(pid)

        crowd_by_cat: Dict[int, int] = {}
        for gid, info in gt_info.items():
            if gid not in gt_areas:
                continue
            if info.get("iscrowd", 0):
                crowd_by_cat[info["category_id"]] = gid
                continue
            if gid not in matched_gt:
                self._bump(self.fn, info["category_id"])

        for pid, info in pred_info.items():
            if pid not in pred_areas or pid in matched_pred:
                continue
            ignored = inter.get((VOID, pid), 0)
            cg = crowd_by_cat.get(info["category_id"])
            if cg is not None:
                ignored += inter.get((cg, pid), 0)
            if ignored / pred_areas[pid] > 0.5:
                continue  # mostly void/crowd: ignore
            self._bump(self.fp, info["category_id"])

    def result(self, thing_ids=None) -> Dict[str, float]:
        cats = set(self.tp) | set(self.fp) | set(self.fn)
        per_class = {}
        for c in cats:
            tp = self.tp.get(c, 0)
            fp = self.fp.get(c, 0)
            fn = self.fn.get(c, 0)
            denom = tp + 0.5 * fp + 0.5 * fn
            if denom == 0:
                continue
            per_class[c] = {
                "pq": self.iou_sum.get(c, 0.0) / denom,
                "sq": self.iou_sum.get(c, 0.0) / tp if tp else 0.0,
                "rq": tp / denom,
            }
        if not per_class:
            return {"PQ": 0.0, "SQ": 0.0, "RQ": 0.0, "n": 0}
        out = {
            "PQ": float(np.mean([v["pq"] for v in per_class.values()])),
            "SQ": float(np.mean([v["sq"] for v in per_class.values()])),
            "RQ": float(np.mean([v["rq"] for v in per_class.values()])),
            "n": len(per_class),
        }
        if thing_ids is not None:
            th = [v["pq"] for c, v in per_class.items() if c in thing_ids]
            st = [v["pq"] for c, v in per_class.items() if c not in thing_ids]
            out["PQ_th"] = float(np.mean(th)) if th else 0.0
            out["PQ_st"] = float(np.mean(st)) if st else 0.0
        return out
