"""HOTA tracking metric (the port's copy of
``univs_tpu/evaluation/hota.py``, which the port may not import).

Rebuild of the reference's auxiliary HOTA evaluation
(reference: univs/evaluation/eval_hota.py — TrackEval-style HOTA:
per-alpha Hungarian matching of detections weighted by association
quality; HOTA = sqrt(DetA x AssA) averaged over alphas 0.05:0.05:0.95).

Inputs per video: per-frame lists of (track_id, mask-or-box) for GT and
predictions plus a similarity function; here we operate on per-frame
binary masks.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

ALPHAS = np.arange(0.05, 0.96, 0.05)


def _mask_iou_matrix(gts: List[np.ndarray], prs: List[np.ndarray]) -> np.ndarray:
    if not gts or not prs:
        return np.zeros((len(gts), len(prs)))
    g = np.stack([m.reshape(-1) for m in gts]).astype(np.float32)
    p = np.stack([m.reshape(-1) for m in prs]).astype(np.float32)
    inter = g @ p.T
    union = g.sum(1)[:, None] + p.sum(1)[None] - inter
    return inter / np.maximum(union, 1)


def hota_single_video(
    gt_frames: Sequence[Dict[int, np.ndarray]],  # per frame: track_id -> mask
    pr_frames: Sequence[Dict[int, np.ndarray]],
) -> Dict[str, float]:
    """HOTA for one video (all frames same resolution)."""
    # global potential-association counts
    pair_inter = defaultdict(float)  # (gid, pid) -> matched frame count (potential)
    gt_count = defaultdict(int)
    pr_count = defaultdict(int)
    per_frame = []
    for gt, pr in zip(gt_frames, pr_frames):
        gids = list(gt)
        pids = list(pr)
        sim = _mask_iou_matrix([gt[i] for i in gids], [pr[j] for j in pids])
        per_frame.append((gids, pids, sim))
        for i in gids:
            gt_count[i] += 1
        for j in pids:
            pr_count[j] += 1
        for a, i in enumerate(gids):
            for b, j in enumerate(pids):
                if sim[a, b] > 0.:
                    pair_inter[(i, j)] += sim[a, b]

    hotas, detas, assas = [], [], []
    for alpha in ALPHAS:
        tp_pairs = defaultdict(int)
        tp, fp, fn = 0, 0, 0
        for gids, pids, sim in per_frame:
            if gids and pids:
                # bias matching toward globally consistent pairs (TrackEval)
                bias = np.array([[pair_inter[(i, j)] for j in pids] for i in gids])
                cost = -(sim + 1e-6 * bias)
                ri, ci = linear_sum_assignment(cost)
                matched_g = set()
                matched_p = set()
                for a, b in zip(ri, ci):
                    if sim[a, b] >= alpha:
                        tp += 1
                        tp_pairs[(gids[a], pids[b])] += 1
                        matched_g.add(gids[a])
                        matched_p.add(pids[b])
                fn += len(gids) - len(matched_g)
                fp += len(pids) - len(matched_p)
            else:
                fn += len(gids)
                fp += len(pids)
        deta = tp / max(tp + fn + fp, 1)
        # association accuracy over TP pairs
        ass = 0.0
        for (i, j), tpa in tp_pairs.items():
            union = gt_count[i] + pr_count[j] - tpa
            ass += tpa * (tpa / max(union, 1))
        assa = ass / max(tp, 1)
        detas.append(deta)
        assas.append(assa)
        hotas.append(np.sqrt(deta * assa))
    return {
        "HOTA": float(np.mean(hotas)),
        "DetA": float(np.mean(detas)),
        "AssA": float(np.mean(assas)),
    }
