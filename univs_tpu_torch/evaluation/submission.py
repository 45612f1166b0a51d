"""Codalab submission emitters for the no-local-GT benchmarks (the port's copy of
``univs_tpu/evaluation/submission.py``, which the port may not import).

Directory layouts are exact transcriptions of the reference writers
(reference: univs/inference/inference_video_vos.py:622-714):

- VOS (YouTube-VOS 2018/19, DAVIS test):
    {output_dir}/inference/Annotations/{video_id}/{frame}.png
  palette PNGs whose pixel value is the 1-based object id (argmax over
  per-object mask logits; 0 = background).
- RefVOS (Ref-YouTube-VOS):
    {output_dir}/inference/Annotations/{video_name}/{exp_id}/{frame}.png
  one grayscale 0/255 binary PNG per expression per frame.

``zip_submission`` packs the Annotations tree the way the codalab
servers expect (Annotations/ at the archive root).
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional, Sequence

import numpy as np


def _frame_png_name(file_name: str) -> str:
    base = os.path.basename(file_name)
    stem = os.path.splitext(base)[0]
    return stem + ".png"


def emit_vos_submission(
    output_dir: str,
    video_id: str,
    file_names: Sequence[str],
    labels: np.ndarray,  # [V, H, W] uint8 label maps (0 = bg, i+1 = object i)
    obj_ids: Optional[Sequence[int]] = None,
) -> str:
    """Write the YTVOS/DAVIS Annotations tree for one video.

    obj_ids: dataset object ids per label index (label i+1 -> obj_ids[i]);
    defaults to 1..N.  Returns the video directory."""
    from univs_tpu_torch.utils.visualization import save_vos_png

    save_dir = os.path.join(output_dir, "inference", "Annotations", str(video_id))
    os.makedirs(save_dir, exist_ok=True)
    lab = labels
    if obj_ids is not None:
        remap = np.zeros(int(labels.max()) + 1, np.uint8)
        for i, oid in enumerate(obj_ids):
            if i + 1 < len(remap):
                remap[i + 1] = oid
        lab = remap[labels]
    V = labels.shape[0]
    assert len(file_names) >= V, (len(file_names), V)
    for t in range(V):
        save_vos_png(lab[t], os.path.join(save_dir, _frame_png_name(file_names[t])))
    return save_dir


def emit_rvos_submission(
    output_dir: str,
    video_name: str,
    exp_ids: Sequence[str],
    file_names: Sequence[str],
    masks: np.ndarray,  # [N_exp, V, H, W] binary
) -> str:
    """Write the Ref-YTVOS per-expression Annotations tree
    (reference: save_rvos_results — masks * 255 grayscale PNGs)."""
    from PIL import Image

    root = os.path.join(output_dir, "inference", "Annotations", str(video_name))
    for i, exp_id in enumerate(exp_ids):
        save_dir = os.path.join(root, str(exp_id))
        os.makedirs(save_dir, exist_ok=True)
        for t in range(masks.shape[1]):
            m = (masks[i, t] > 0).astype(np.uint8) * 255
            Image.fromarray(m).save(
                os.path.join(save_dir, _frame_png_name(file_names[t]))
            )
    return root


def id2rgb(seg_id: int):
    """panopticapi id encoding: id = R + G*256 + B*256^2."""
    return (seg_id % 256, (seg_id // 256) % 256, (seg_id // 256 // 256) % 256)


def emit_vps_submission(
    output_dir: str,
    video_id: str,
    file_names: Sequence[str],
    panoptic: np.ndarray,  # [V, H, W] int32 segment ids (0 = void)
    segments_info: Sequence[dict],  # [{id, isthing, category_id(1-based)}]
) -> dict:
    """Write the VIPSeg evaluator input layout for one video —
    ``pan_pred/{video_id}/{frame}.png`` RGB id-encoded panoptic maps +
    the per-video annotations dict for ``pred.json``
    (reference: univs/evaluation/vps_evaluation.py:118-179).

    Colors encode the segment id via the panopticapi id2rgb convention,
    so ``rgb2id(png) == segments_info[..]['id']`` exactly as the VPQ/STQ
    kernels expect.  Returns {'annotations': [...], 'video_id'} to
    aggregate into pred.json via :func:`write_vps_pred_json`.
    """
    from PIL import Image

    V, H, W = panoptic.shape
    save_dir = os.path.join(output_dir, "pan_pred", str(video_id))
    os.makedirs(save_dir, exist_ok=True)

    pan_rgb = np.zeros((V, H, W, 3), np.uint8)
    per_seg_frames = []
    for seg in segments_info:
        sid = int(seg["id"])
        mask = panoptic == sid
        pan_rgb[mask] = np.array(id2rgb(sid), np.uint8)
        dts = []
        base = {"category_id": int(seg["category_id"]) - 1, "iscrowd": 0, "id": sid}
        for t in range(V):
            ys, xs = np.nonzero(mask[t])
            if len(ys) == 0:
                dts.append(None)
                continue
            x, y = int(xs.min()), int(ys.min())
            dts.append({
                "bbox": [x, y, int(xs.max()) - x, int(ys.max()) - y],
                "area": int(mask[t].sum()), **base,
            })
        per_seg_frames.append(dts)

    annotations = []
    for t in range(V):
        name = os.path.basename(file_names[t]) if t < len(file_names) else f"{t:05d}.jpg"
        Image.fromarray(pan_rgb[t]).save(
            os.path.join(save_dir, os.path.splitext(name)[0] + ".png")
        )
        annotations.append({
            "segments_info": [d[t] for d in per_seg_frames if d[t] is not None],
            "file_name": name,
        })
    return {"annotations": annotations, "video_id": str(video_id)}


def write_vps_pred_json(output_dir: str, per_video: Sequence[dict]) -> str:
    """Aggregate per-video dicts into pred.json
    (reference: vps_evaluation.py:196-199)."""
    import json

    path = os.path.join(output_dir, "pred.json")
    with open(path, "w") as f:
        json.dump({"annotations": list(per_video)}, f)
    return path


def zip_submission(output_dir: str, zip_name: str = "submission.zip") -> str:
    """Zip {output_dir}/inference/Annotations -> {output_dir}/{zip_name}
    with 'Annotations/...' arcnames (codalab layout)."""
    ann_root = os.path.join(output_dir, "inference", "Annotations")
    out_path = os.path.join(output_dir, zip_name)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, _, files in sorted(os.walk(ann_root)):
            for f in sorted(files):
                full = os.path.join(dirpath, f)
                arc = os.path.join("Annotations", os.path.relpath(full, ann_root))
                zf.write(full, arc)
    return out_path
