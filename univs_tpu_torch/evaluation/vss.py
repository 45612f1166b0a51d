"""VSS metrics: mIoU / mAcc (confusion matrix) + video consistency mVC (the port's copy of
``univs_tpu/evaluation/vss.py``, which the port may not import).

Standalone numpy rebuild of the reference's VSPW evaluation
(reference: univs/evaluation/eval_miou_vss.py + eval_utils_vss.py
confusion-matrix kernels; eval_vc_perclip_vss.py for mVC).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def confusion_matrix(gt: np.ndarray, pred: np.ndarray, num_classes: int,
                     ignore_label: int = 255) -> np.ndarray:
    """Accumulate a [C, C] confusion matrix (rows = GT)."""
    keep = gt != ignore_label
    g = gt[keep].astype(np.int64)
    p = pred[keep].astype(np.int64)
    p = np.clip(p, 0, num_classes - 1)
    idx = g * num_classes + p
    cm = np.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray) -> Tuple[float, float, np.ndarray]:
    """-> (mIoU, mAcc, per-class IoU). Classes absent from GT and
    predictions are excluded from the mean."""
    inter = np.diag(cm).astype(np.float64)
    gt_tot = cm.sum(1).astype(np.float64)
    pr_tot = cm.sum(0).astype(np.float64)
    union = gt_tot + pr_tot - inter
    present = union > 0
    iou = np.where(present, inter / np.maximum(union, 1), np.nan)
    acc = np.where(gt_tot > 0, inter / np.maximum(gt_tot, 1), np.nan)
    miou = float(np.nanmean(np.where(present, iou, np.nan)))
    macc = float(np.nanmean(np.where(gt_tot > 0, acc, np.nan)))
    return miou, macc, iou


def video_consistency(gt_frames: Sequence[np.ndarray], pred_frames: Sequence[np.ndarray],
                      window: int = 8, ignore_label: int = 255) -> float:
    """mVC_n: for each length-n clip, |(∩GT) ∩ (∩Pred)| / |∩GT|
    averaged over clips (VSPW video-consistency metric).

    Frames are [H, W] label maps."""
    T = len(gt_frames)
    if T < window:
        return float("nan")
    scores = []
    for s in range(T - window + 1):
        g = np.stack(gt_frames[s : s + window])
        p = np.stack(pred_frames[s : s + window])
        valid = (g != ignore_label).all(0)
        g_common = valid & (g == g[0]).all(0)
        p_common = g_common & (p == p[0]).all(0) & (p[0] == g[0])
        denom = g_common.sum()
        if denom > 0:
            scores.append(p_common.sum() / denom)
    return float(np.mean(scores)) if scores else float("nan")
