"""Video dataset mapper: records -> fixed-shape training/eval arrays (the port's copy of
``univs_tpu/data/mapper.py``, which the port may not import).

Rebuild of the reference's ``UniVidDatasetMapper``
(reference: univs/data/dataset_mapper_uni_vid.py:145-693): reference-
frame window sampling per dataset family (:259-285), image->pseudo-
video replication for image datasets (:249-256), absolute frame-index
shift for the ArbitraryT PE (:288-294), clip-consistent augmentation,
and annotations -> fixed-capacity target arrays with -1 ids for absent
frames.  Outputs are plain numpy, ready to stack into a TrainBatch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from univs_tpu_torch.data.augment import (
    ClipTransform,
    TrainAugConfig,
    resize_shortest_edge,
    sample_clip_transforms,
    transformed_image_size,
)
from univs_tpu_torch.data.video import read_video_frames
from univs_tpu_torch.data.ytvis import segmentation_to_mask


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


@dataclass
class TrainMapperConfig:
    num_frames: int = 2
    sampling_interval: int = 5  # max gap between sampled frames
    image_size: int = 1024  # LSJ canvas
    min_scale: float = 0.25
    max_scale: float = 4.0
    max_instances: int = 40
    mask_stride: int = 4  # store GT masks at 1/4 of the canvas
    num_max_frames: int = 128  # ArbitraryT PE normalizer
    # pseudo-video extras for image datasets (reference
    # cfg.INPUT.PSEUDO.AUGMENTATIONS: color jitter + rotation applied to
    # still->clip replication; build_augmentation:471-483)
    pseudo_color_jitter: bool = True
    pseudo_rotation: bool = True


class TrainVideoMapper:
    def __init__(self, cfg: TrainMapperConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)

    def __call__(self, record: Dict) -> Optional[Dict]:
        c = self.cfg
        is_raw_video = "video_path" in record and not record.get("file_names")
        if is_raw_video:
            V = int(record.get("video_len") or record.get("length") or 0)
            if V <= 0:
                from univs_tpu_torch.data.video import video_num_frames

                V = video_num_frames(record["video_path"])
        else:
            V = len(record["file_names"])
        T = c.num_frames

        # reference-frame window sampling around a random center
        center = self.rng.randint(V)
        lo = max(0, center - c.sampling_interval)
        hi = min(V - 1, center + c.sampling_interval)
        choices = np.arange(lo, hi + 1)
        idxs = np.sort(self.rng.choice(choices, size=min(T, len(choices)), replace=len(choices) < T))
        while len(idxs) < T:  # replicate for very short videos
            idxs = np.concatenate([idxs, idxs[-1:]])
        idxs = idxs[:T]

        if is_raw_video:
            # mp4 decode path (reference: dataset_mapper_uni_vid.py:330-345)
            frames = read_video_frames(record["video_path"], idxs)
        else:
            frames = [_load_image(record["file_names"][i]) for i in idxs]
        h, w = frames[0].shape[:2]
        # per-frame transform pipeline; pseudo-video clips from a single
        # still get the color-jitter + rotation extras
        pseudo = V == 1
        aug_cfg = TrainAugConfig(
            image_size=c.image_size, min_scale=c.min_scale, max_scale=c.max_scale,
            color_jitter=pseudo and c.pseudo_color_jitter,
            rotation=pseudo and c.pseudo_rotation,
        )
        tfs = sample_clip_transforms(self.rng, (h, w), T, aug_cfg)
        images = np.stack(
            [tf.apply_image(f) for tf, f in zip(tfs, frames)]
        ).astype(np.float32)

        ms = c.image_size // c.mask_stride
        N = c.max_instances
        labels = np.zeros((N,), np.int32)
        ids = np.full((N, T), -1, np.int32)
        masks = np.zeros((N, T, ms, ms), np.float32)
        valid = np.zeros((N,), bool)

        anns = record.get("annotations", [])[:N]
        for n, ann in enumerate(anns):
            labels[n] = ann["category_id"]
            any_present = False
            for ti, fi in enumerate(idxs):
                segm = ann["segmentations"][fi] if ann.get("segmentations") else None
                m = segmentation_to_mask(segm, record["height"], record["width"])
                if m is None or m.sum() == 0:
                    continue
                m = tfs[ti].apply_mask(m)
                # downsample to mask stride (nearest)
                m = m[:: c.mask_stride, :: c.mask_stride][:ms, :ms]
                if m.sum() == 0:
                    continue
                masks[n, ti] = m
                ids[n, ti] = ann["id"]
                any_present = True
            valid[n] = any_present

        if not valid.any():
            return None

        # absolute frame indices (shifted into [0, num_max_frames))
        fi_abs = idxs - idxs.min()
        fi_abs = np.clip(fi_abs, 0, c.num_max_frames - 1)

        return {
            "images": images,  # [T, S, S, 3] float32 RGB 0-255
            "frame_indices": fi_abs.astype(np.int32),
            "labels": labels,
            "ids": ids,
            "masks": masks,
            "valid": valid,
            "dataset_name": record["dataset_name"],
            "task": record["task"],
        }


class EvalVideoMapper:
    """Whole-video eval mapper: shortest-edge resize + divisibility pad
    (reference eval transform — SURVEY §7.11)."""

    def __init__(self, short: int = 640, max_size: int = 1333, size_divisibility: int = 32):
        self.short = short
        self.max_size = max_size
        self.div = size_divisibility

    def __call__(self, record: Dict) -> Dict:
        if "video_path" in record and not record.get("file_names"):
            # raw-video datasets (custom_videos / InternVid / Pexels):
            # mp4 decode in the mapper, as the reference does
            # (dataset_mapper_uni_vid.py:330-345)
            frames = read_video_frames(
                record["video_path"], None, record.get("max_frames", 10000)
            )
        else:
            frames = [_load_image(p) for p in record["file_names"]]
        h, w = frames[0].shape[:2]
        t = resize_shortest_edge((h, w), self.short, self.max_size, self.div)
        images = np.stack([t.apply_image(f) for f in frames]).astype(np.float32)
        ih, iw = transformed_image_size(t, (h, w))
        return {
            "images": images,
            "image_size": (ih, iw),  # content size within the padded canvas
            "out_size": (record.get("height", h), record.get("width", w)),
            "video_id": record["video_id"],
            "video_len": len(frames),
            "dataset_name": record["dataset_name"],
            "task": record["task"],
            "record": record,
            "transform": t,
        }
