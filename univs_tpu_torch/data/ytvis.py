"""COCO-video ("ytvis-format") JSON loading (the port's copy of
``univs_tpu/data/ytvis.py``, which the port may not import).

Standalone rebuild of the reference's ``load_ytvis_json`` + ytvis_api
(reference: univs/data/datasets/ytvis.py:143-439): a dataset JSON has
``videos`` (id, file_names, height, width, length), ``annotations``
(video_id, category_id, per-frame segmentations/bboxes/areas, id), and
``categories``.  Records get a task tag at load time: expression
datasets -> 'grounding', sot datasets -> 'sot', else 'detection'
(ytvis.py:330-336).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def load_ytvis_json(
    json_file: str,
    image_root: str,
    dataset_name: str = "",
    has_expression: bool = False,
    sot: bool = False,
) -> List[Dict]:
    with open(json_file) as f:
        data = json.load(f)

    task = "grounding" if has_expression else ("sot" if sot else "detection")

    anns_by_video: Dict[int, List] = {}
    for ann in data.get("annotations", []):
        anns_by_video.setdefault(ann["video_id"], []).append(ann)

    cat_ids = sorted(c["id"] for c in data.get("categories", []))
    # contiguous 1-based labels (reference convention: labels start at 1)
    cat_map = {cid: i + 1 for i, cid in enumerate(cat_ids)}

    records = []
    for video in data["videos"]:
        vid = video["id"]
        rec = {
            "video_id": vid,
            "dataset_name": dataset_name,
            "file_names": [os.path.join(image_root, f) for f in video["file_names"]],
            "height": video["height"],
            "width": video["width"],
            "length": video.get("length", len(video["file_names"])),
            "task": task,
            "annotations": [],
        }
        if has_expression:
            rec["expressions"] = video.get("expressions", [])
            rec["exp_obj_ids"] = video.get("exp_obj_ids", list(range(len(rec["expressions"]))))
        for ann in anns_by_video.get(vid, []):
            rec["annotations"].append(
                {
                    "id": ann["id"],
                    "category_id": cat_map.get(ann.get("category_id"), 0),
                    # original json id — the VIPOSeg G protocol buckets by
                    # the dataset's own class ids, not the contiguous remap
                    "raw_category_id": ann.get("category_id", 0),
                    "segmentations": ann.get("segmentations"),
                    "bboxes": ann.get("bboxes"),
                    "areas": ann.get("areas"),
                    "iscrowd": ann.get("iscrowd", 0),
                }
            )
        records.append(rec)
    return records


def segmentation_to_mask(segm, height: int, width: int) -> Optional[np.ndarray]:
    """Per-frame segmentation (RLE dict / polygon list / None) -> binary
    mask [H, W] or None for absent frames."""
    if segm is None:
        return None
    if isinstance(segm, dict):
        from univs_tpu_torch.utils import rle

        counts = segm["counts"]
        if isinstance(counts, list):
            # uncompressed RLE: counts are plain run lengths
            flat = np.zeros(height * width, np.uint8)
            pos, v = 0, 0
            for c in counts:
                if v:
                    flat[pos : pos + c] = 1
                pos += c
                v = 1 - v
            return flat.reshape(height, width, order="F")
        return rle.decode(segm)
    if isinstance(segm, list):
        return polygons_to_mask(segm, height, width)
    raise TypeError(type(segm))


def polygons_to_mask(polygons: List, height: int, width: int) -> np.ndarray:
    """COCO polygon(s) -> binary mask (PIL rasterization)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        if len(poly) >= 6:
            draw.polygon([tuple(p) for p in np.asarray(poly).reshape(-1, 2)], outline=1, fill=1)
    return np.asarray(img, np.uint8)
