"""DAVIS J&F metrics (region similarity + boundary F-measure) (the port's copy of
``univs_tpu/evaluation/davis.py``, which the port may not import).

Standalone numpy implementation of the metrics in the reference's
vendored davis2017-evaluation package
(reference: univs/evaluation/davis2017_evaluation/davis2017/
metrics.py:6-122 — db_eval_iou, db_eval_boundary with seg2bmap and
disk-dilated boundary matching).  Used for VOS (DAVIS/YTVOS/MOSE) and
RefVOS J&F scoring.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray, void_pixels=None) -> np.ndarray:
    """Region similarity J: IoU per frame.

    annotation/segmentation: [T, H, W] or [H, W] binary.
    Empty GT + empty prediction scores 1 (davis2017 convention)."""
    ann = annotation > 0.5
    seg = segmentation > 0.5
    if void_pixels is not None:
        keep = ~(void_pixels > 0.5)
        ann = ann & keep
        seg = seg & keep
    axis = tuple(range(ann.ndim - 2, ann.ndim))
    inter = np.logical_and(ann, seg).sum(axis=axis).astype(np.float64)
    union = np.logical_or(ann, seg).sum(axis=axis).astype(np.float64)
    j = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    return j


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Binary mask -> boundary map, the David Martin bmap law used by
    davis2017-evaluation (metrics.py:122-178): symmetric XOR against
    the east/south/southeast shifts (marks BOTH sides of each edge),
    XOR-only on the last row/column, and a forced-zero corner.  Pinned
    to the vendored package by tests/test_golden_metrics.py."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk_dilate(m: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation with an approximately circular structuring element."""
    if radius <= 0:
        return m
    from scipy import ndimage

    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    disk = (x * x + y * y) <= radius * radius
    return ndimage.binary_dilation(m, structure=disk)


def db_eval_boundary(annotation: np.ndarray, segmentation: np.ndarray,
                     void_pixels=None, bound_th: float = 0.008) -> np.ndarray:
    """Boundary F-measure per frame (davis2017 f_measure)."""
    if annotation.ndim == 2:
        annotation = annotation[None]
        segmentation = segmentation[None]
    T = annotation.shape[0]
    out = np.zeros(T)
    for t in range(T):
        out[t] = _f_measure_frame(annotation[t], segmentation[t], bound_th)
    return out


def _f_measure_frame(ann: np.ndarray, seg: np.ndarray, bound_th: float) -> float:
    ann = ann > 0.5
    seg = seg > 0.5
    bound_pix = (
        bound_th if bound_th >= 1 else int(np.ceil(bound_th * np.linalg.norm(ann.shape)))
    )
    fg_b = _seg2bmap(seg)
    gt_b = _seg2bmap(ann)
    fg_dil = _disk_dilate(fg_b, bound_pix)
    gt_dil = _disk_dilate(gt_b, bound_pix)
    gt_match = gt_b & fg_dil
    fg_match = fg_b & gt_dil
    n_fg = fg_b.sum()
    n_gt = gt_b.sum()
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0
    precision = fg_match.sum() / n_fg
    recall = gt_match.sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def evaluate_davis_sequence(
    gt_masks: np.ndarray,  # [N_obj, T, H, W] binary
    pred_masks: np.ndarray,  # [N_obj, T, H, W] binary (same object order)
) -> Dict[str, float]:
    """Per-sequence J&F means over objects and frames (excluding the
    first and last frame per DAVIS protocol)."""
    n, t = gt_masks.shape[:2]
    js, fs = [], []
    for i in range(n):
        j = db_eval_iou(gt_masks[i], pred_masks[i])
        f = db_eval_boundary(gt_masks[i], pred_masks[i])
        sl = slice(1, t - 1) if t > 2 else slice(0, t)
        js.append(j[sl].mean())
        fs.append(f[sl].mean())
    jm = float(np.mean(js))
    fm = float(np.mean(fs))
    return {"J": jm, "F": fm, "J&F": (jm + fm) / 2}
