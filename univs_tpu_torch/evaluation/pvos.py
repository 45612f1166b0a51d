"""PVOS (VIPOSeg) G-score — the reference's exact protocol (the port's copy of
``univs_tpu/evaluation/pvos.py``, which the port may not import).

Standalone rebuild of the reference's VIPOSeg evaluation
(reference: univs/evaluation/eval_pvos.py:12-135 +
eval_utils_viposeg.py):

- objects enter evaluation at the frame AFTER their reference
  (annotation) frame — frames at/before the ref frame are excluded
  (eval_pvos.py:97-102: ``obj_ids`` is extended after the frame's
  scoring pass);
- per (object, frame): mask IoU and boundary IoU with the empty-mask
  laws (pred empty xor gt empty -> 0; both empty -> 1, :60-72);
- samples are pooled into FLAT per-bucket lists across all objects,
  frames, and videos: thing/stuff x seen/unseen (:74-93); class 98
  ("other machine") routes to stuff, seen/unseen by VIDEO membership
  in ``OTHER_MACHINE_UNSEEN_VIDEOS``;
- bucket score = (mean mIoU + mean bIoU) / 2; the G score
  (``overall_iou``) is the mean of the FOUR bucket scores (:115-119);
- optional decay: per-(obj, frame) (miou+biou)/2 keyed by the number
  of objects introduced so far, exponential fit via least squares
  (:120-135).

The class tables below are the VIPOSeg dataset contract
(eval_utils_viposeg.py:4-22) — they ARE the data, not code.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

# --- VIPOSeg class tables (eval_utils_viposeg.py:4-22) ---------------------

THING_CLASSES = [
    60, 89, 90, 8, 48, 2, 79, 106, 76, 84, 114, 74, 108, 91, 83, 85, 54, 65,
    78, 44, 92, 122, 107, 43, 88, 117, 50, 51, 87, 52, 62, 115, 10, 41, 77,
    82, 56, 123, 49, 4, 63, 102, 99, 109, 47, 55, 61, 118, 72, 46, 96, 64,
    101, 86, 97, 100, 116, 95,
]
STUFF_CLASSES = [
    28, 66, 0, 14, 15, 13, 7, 12, 22, 68, 1, 59, 27, 75, 40, 29, 18, 21, 19,
    39, 30, 11, 53, 111, 45, 35, 98, 36, 119, 42, 104, 23, 80, 93, 67, 3, 31,
    16, 69, 103, 37, 121, 110, 105, 33, 24, 70, 73, 32, 9, 71, 120, 58, 94,
    5, 34, 20, 6,
]
THING_UNSEEN = frozenset(
    [102, 99, 109, 47, 55, 61, 118, 72, 46, 96, 64, 101, 86, 97, 100, 116, 95]
)
STUFF_UNSEEN = frozenset(
    [9, 71, 120, 58, 94, 5, 34, 20, 6, 26, 112, 17, 57, 113, 25, 81, 38]
)
OTHER_MACHINE_CLASS = 98
OTHER_MACHINE_UNSEEN_VIDEOS = frozenset([
    "187_WUZUSD4477I", "319_l1Dz12fxQzQ", "320_nhKXemkIvh4", "517_AWvYuplla_s",
    "532_QmZyJuLlEec", "774_devdFjIpDcc", "1016_HG0AsTOxI5g", "1017_IAU0WGB9VPw",
    "1020_TgCIv6bp3XM", "1021_cPOxAMo28yk", "1022_emSaDd2ddj0", "1033_sh81AwYuihg",
    "1065_d2sHRyAHKqI", "1067_fk3jhxBi1pA", "1068_gxnZkf0LQfk", "1069_jFHRbZxswz8",
    "1070_uTJB31tuYes", "1072_zvNEdUk5k0Q", "1230_AGY-gQ_3O8Y", "1333__iprMPKLdOQ",
    "1334_qlmfvYA3_rk", "2004_1btxeVbyojs", "2005_83KrhWajwfw",
])
THING_SEEN = frozenset(c for c in THING_CLASSES if c not in THING_UNSEEN)
STUFF_SEEN = frozenset(c for c in STUFF_CLASSES if c not in STUFF_UNSEEN)

BUCKETS = ("thing_seen", "thing_unseen", "stuff_seen", "stuff_unseen")


def mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    """Boundary band of a binary mask (eval_utils_viposeg.py:26-45).

    The reference zero-pads by 1 and cv2-erodes with a 3x3 kernel for
    ``dilation`` iterations; scipy's binary_erosion with border_value=0
    is the identical operator (zeros propagate inward from the border
    each iteration) without the explicit pad."""
    h, w = mask.shape
    dilation = max(1, int(round(dilation_ratio * np.sqrt(h ** 2 + w ** 2))))
    m = mask > 0
    eroded = ndimage.binary_erosion(
        m, structure=np.ones((3, 3), bool), iterations=dilation, border_value=0
    )
    return m & ~eroded


def boundary_iou(gt: np.ndarray, dt: np.ndarray, dilation_ratio: float = 0.02) -> float:
    """Boundary IoU (eval_utils_viposeg.py:64-83); 0 when both empty."""
    gb = mask_to_boundary(gt, dilation_ratio)
    db = mask_to_boundary(dt, dilation_ratio)
    union = (gb | db).sum()
    if union == 0:
        return 0.0
    return float((gb & db).sum() / union)


def bucket_of(class_id: int, video_unseen_machine: bool) -> Optional[str]:
    """eval_pvos.py:74-93; None = class not in any table (dropped)."""
    if class_id == OTHER_MACHINE_CLASS:
        return "stuff_unseen" if video_unseen_machine else "stuff_seen"
    if class_id in THING_UNSEEN:
        return "thing_unseen"
    if class_id in STUFF_UNSEEN:
        return "stuff_unseen"
    if class_id in THING_SEEN:
        return "thing_seen"
    if class_id in STUFF_SEEN:
        return "stuff_seen"
    return None


def pvos_video_samples(
    gt_id_maps: np.ndarray,  # [T, H, W] int object-id maps (0 = background)
    pred_id_maps: np.ndarray,  # [T, H, W]
    obj_classes: Dict[int, int],  # object id -> VIPOSeg class id
    ann_frames: Dict[int, np.ndarray],  # frame idx -> reference id map
    video_unseen_machine: bool = False,
) -> Tuple[Dict[str, List[Tuple[float, float]]], Dict[int, List[float]]]:
    """One video's per-(object, frame) samples, reference frame-loop law.

    Returns (bucket -> [(miou, biou)...], obj_count -> [decay samples]).
    """
    buckets: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    decay: Dict[int, List[float]] = defaultdict(list)
    obj_ids: List[int] = []
    T = gt_id_maps.shape[0]
    for i in range(T):
        label = gt_id_maps[i]
        pred = pred_id_maps[i]
        obj_num = len(obj_ids)
        for oid in obj_ids:
            mask_gt = label == oid
            mask_pred = pred == oid
            gs, ps = mask_gt.sum(), mask_pred.sum()
            if ps == 0 and gs != 0:
                miou = biou = 0.0
            elif ps != 0 and gs == 0:
                miou = biou = 0.0
            elif ps == 0 and gs == 0:
                miou = biou = 1.0
            else:
                miou = float((mask_gt & mask_pred).sum() / (mask_gt | mask_pred).sum())
                biou = boundary_iou(mask_gt, mask_pred)
            b = bucket_of(int(obj_classes[oid]), video_unseen_machine)
            if b is not None:
                buckets[b].append((miou, biou))
            decay[obj_num].append((miou + biou) / 2.0)
        # objects annotated at frame i enter evaluation from frame i+1
        # (eval_pvos.py:97-102)
        if i in ann_frames:
            obj_ids.extend(int(x) for x in np.unique(ann_frames[i]) if x != 0)
    return buckets, decay


def pvos_aggregate(bucket_samples: Dict[str, List[Tuple[float, float]]]) -> Dict[str, float]:
    """Pooled-bucket aggregation (eval_pvos.py:105-119).

    overall_iou ("G") = mean of the four thing/stuff x seen/unseen bucket
    scores, each (mean mIoU + mean bIoU) / 2; empty buckets are NaN (the
    reference's np.mean([]) warning case) and propagate into the mean —
    callers evaluating subsets should read the per-bucket keys.
    """
    out: Dict[str, float] = {}
    for b in BUCKETS:
        s = bucket_samples.get(b, [])
        m = float(np.mean([x[0] for x in s])) if s else float("nan")
        bi = float(np.mean([x[1] for x in s])) if s else float("nan")
        out[f"{b}_miou"] = m
        out[f"{b}_biou"] = bi
        out[f"{b}_iou"] = (m + bi) / 2
    out["overall_iou"] = float(np.mean([out[f"{b}_iou"] for b in BUCKETS]))
    # convenience: G over the buckets that have samples (for dev subsets
    # that lack e.g. unseen stuff entirely)
    present = [out[f"{b}_iou"] for b in BUCKETS if not np.isnan(out[f"{b}_iou"])]
    out["G"] = float(np.mean(present)) if present else 0.0
    return out


def pvos_decay_fit(decay: Dict[int, List[float]]) -> float:
    """Exponential decay coefficient (eval_pvos.py:120-135)."""
    x, y = [], []
    for k, v in decay.items():
        if v != [] and k < 60:
            x.append(k)
            y.append(float(np.mean(v)))
    if not x:  # empty/all-filtered decay dict: no fit, not a LinAlgError
        return float("nan")
    A = np.asarray(x, np.float64)[:, None] / 100.0
    b = -np.log(np.asarray(y, np.float64)[:, None])
    coef = np.linalg.inv(A.T @ A) @ A.T @ b
    return float(coef[0, 0])


def evaluate_pvos_video(
    gt_masks: np.ndarray,  # [N, T, H, W] binary per-object masks
    pred_masks: np.ndarray,  # [N, T, H, W]
    obj_classes: Sequence[int],
    ref_frames: Optional[Sequence[int]] = None,  # per-object reference frame
    video_unseen_machine: bool = False,
) -> Dict[str, float]:
    """Single-video convenience wrapper over the sample/aggregate pair.

    ``ref_frames`` defaults to 0 for every object (objects are scored
    from frame 1 on).
    """
    n, t = gt_masks.shape[:2]
    ids = np.arange(1, n + 1)
    gt_ids = np.zeros(gt_masks.shape[1:], np.int32)
    pr_ids = np.zeros(pred_masks.shape[1:], np.int32)
    for i in range(n):
        gt_ids[gt_masks[i] > 0] = ids[i]
        pr_ids[pred_masks[i] > 0] = ids[i]
    refs = list(ref_frames) if ref_frames is not None else [0] * n
    ann: Dict[int, np.ndarray] = {}
    for i, rf in enumerate(refs):
        m = (gt_masks[i, rf] > 0).astype(np.int32) * ids[i]
        ann[rf] = np.where(m > 0, m, ann.get(rf, np.zeros_like(m)))
    samples, _ = pvos_video_samples(
        gt_ids, pr_ids, {int(ids[i]): int(obj_classes[i]) for i in range(n)},
        ann, video_unseen_machine,
    )
    return pvos_aggregate(samples)
