"""Segmentation and Tracking Quality (STQ) for VPS (the port's copy of
``univs_tpu/evaluation/stq.py``, which the port may not import).

Standalone numpy rebuild of the reference's STQ evaluation
(reference: univs/evaluation/eval_stq_vps.py / eval_stquality_vps.py —
STQ = sqrt(AQ x SQ): association quality over thing tracks weighted by
tube IoU, semantic quality = class mIoU).  Follows the STEP benchmark
definition (Weber et al.).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np


class STQAccumulator:
    def __init__(self, num_classes: int, things: set, max_ins: int = 10000, ignore_label: int = 255):
        self.num_classes = num_classes
        self.things = set(things)
        self.max_ins = max_ins
        self.ignore = ignore_label
        self.iou_cm = np.zeros((num_classes, num_classes), np.float64)
        # association stats keyed by (video, gt_track)
        self.intersections = defaultdict(lambda: defaultdict(float))
        self.gt_sizes = defaultdict(float)
        self.pr_sizes = defaultdict(float)

    def update(self, video_id, gt_class: np.ndarray, gt_inst: np.ndarray,
               pr_class: np.ndarray, pr_inst: np.ndarray):
        """Per frame: [H, W] class maps + instance-id maps."""
        valid = gt_class != self.ignore
        g_c = gt_class[valid].astype(np.int64)
        p_c = np.clip(pr_class[valid].astype(np.int64), 0, self.num_classes - 1)
        cm = np.bincount(g_c * self.num_classes + p_c,
                         minlength=self.num_classes * self.num_classes)
        self.iou_cm += cm.reshape(self.num_classes, self.num_classes)

        # association over thing pixels
        g_i = gt_inst[valid].astype(np.int64)
        p_i = pr_inst[valid].astype(np.int64)
        is_thing_gt = np.isin(g_c, list(self.things))
        gt_key = g_c * self.max_ins + g_i
        pr_key = p_c * self.max_ins + p_i
        # gt track sizes
        ids, cnt = np.unique(gt_key[is_thing_gt], return_counts=True)
        for i, c in zip(ids.tolist(), cnt.tolist()):
            self.gt_sizes[(video_id, i)] += c
        is_thing_pr = np.isin(p_c, list(self.things))
        ids, cnt = np.unique(pr_key[is_thing_pr], return_counts=True)
        for i, c in zip(ids.tolist(), cnt.tolist()):
            self.pr_sizes[(video_id, i)] += c
        both = is_thing_gt & is_thing_pr
        comb = gt_key[both] * (2 ** 42) + pr_key[both]
        ids, cnt = np.unique(comb, return_counts=True)
        for i, c in zip(ids.tolist(), cnt.tolist()):
            self.intersections[(video_id, i >> 42)][i & ((1 << 42) - 1)] += c

    def result(self) -> Dict[str, float]:
        inter = np.diag(self.iou_cm)
        union = self.iou_cm.sum(0) + self.iou_cm.sum(1) - inter
        present = union > 0
        sq = float(np.mean(inter[present] / union[present])) if present.any() else 0.0

        aq_sum, n_tracks = 0.0, 0
        for (vid, gkey), preds in self.intersections.items():
            gt_size = self.gt_sizes[(vid, gkey)]
            if gt_size == 0:
                continue
            track_aq = 0.0
            for pkey, i_sz in preds.items():
                pr_size = self.pr_sizes.get((vid, pkey), 0.0)
                union_t = gt_size + pr_size - i_sz
                if union_t > 0:
                    track_aq += (i_sz / union_t) * i_sz
            aq_sum += track_aq / gt_size
            n_tracks += 1
        # tracks never intersected still count
        for key, gt_size in self.gt_sizes.items():
            if key not in self.intersections:
                n_tracks += 1
        aq = aq_sum / max(n_tracks, 1)
        return {"STQ": float(np.sqrt(aq * sq)), "AQ": float(aq), "SQ": sq}
