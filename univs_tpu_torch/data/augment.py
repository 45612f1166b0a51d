"""Clip augmentations (numpy/cv2, host-side) (the port's copy of
``univs_tpu/data/augment.py``, which the port may not import).

Rebuild of the reference's clip augmentation stack
(reference: univs/data/augmentation.py:22-520 + build_augmentation):

Training recipe (LSJ, configs/univs/Base.yaml:107-111):
  1. RandomFlipClip            — one flip decision per CLIP (:401-438)
  2. color jitter              — brightness/contrast/saturation, d2
     Random{Brightness,Contrast,Saturation}(0.9, 1.1), sampled PER
     FRAME (plain d2 augs in build_augmentation:471-477; used for
     pseudo-video clips from stills)
  3. RandomRotationClip        — per-clip sorted angle progression
     (uniform[-15,15] per frame, sorted, order reversed w.p. 0.5),
     shared jittered center in [0.4,0.6]^2, expand=False (:66-127,:479-483)
  4. ResizeScale               — random target scale sampled PER FRAME
     (plain T.ResizeScale in build_augmentation:486-489; scale jitter
     across frames is intentional for pseudo-videos)
  5. FixedSizeCropClip         — clip-shared base crop offset; frames
     after the first add a pseudo-temporal shift of up to 10% of the
     crop size (:272-340; the reference's `self._cnt > 0 &
     pseudo_temporal_shift` parses as `cnt > 0`, i.e. the shift is
     always on past frame 0 — reproduced); pad bottom/right to the
     square canvas.

Eval: ResizeShortestEdgeClip (deterministic) + divisibility pad.
Masks use nearest interpolation, images bilinear (d2 semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

# OpenCV's interpolation codes (cv2.INTER_NEAREST, cv2.INTER_LINEAR), so
# that a transform that needs no resize or rotation never imports cv2
INTER_NEAREST, INTER_LINEAR = 0, 1

# ---------------------------------------------------------------------------
# per-frame resolved transform
# ---------------------------------------------------------------------------


@dataclass
class FrameTransform:
    """Resolved geometric+photometric transform for ONE frame.

    Application order mirrors the reference augmentation list: flip ->
    color -> rotation (expand=False) -> resize(scale) -> crop -> pad.
    """

    flip: bool
    out_size: Tuple[int, int]  # final (H, W) canvas
    scale: float  # resize factor applied before crop/pad
    crop_y: int = 0
    crop_x: int = 0
    # photometric (1.0 = identity); image-only
    brightness: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0
    # rotation (degrees ccw, around absolute center, same-size output)
    rot_angle: float = 0.0
    rot_center: Optional[Tuple[float, float]] = None  # relative (x, y)

    # -- helpers --------------------------------------------------------

    def _geo(self, img: np.ndarray, interp: int) -> np.ndarray:
        if self.flip:
            img = img[:, ::-1]
        if self.rot_angle % 360 != 0:
            import cv2

            h, w = img.shape[:2]
            cx, cy = self.rot_center or (0.5, 0.5)
            mat = cv2.getRotationMatrix2D((w * cx, h * cy), self.rot_angle, 1.0)
            img = cv2.warpAffine(np.ascontiguousarray(img), mat, (w, h), flags=interp)
        h, w = img.shape[:2]
        nh = max(1, int(round(h * self.scale)))
        nw = max(1, int(round(w * self.scale)))
        # OpenCV's resize copies at equal size: skip it (and cv2) there
        if (nh, nw) != (h, w):
            import cv2

            img = cv2.resize(np.ascontiguousarray(img), (nw, nh), interpolation=interp)
        out_shape = (*self.out_size, img.shape[2]) if img.ndim == 3 else self.out_size
        out = np.zeros(out_shape, img.dtype)
        src = img[self.crop_y : self.crop_y + self.out_size[0], self.crop_x : self.crop_x + self.out_size[1]]
        out[: src.shape[0], : src.shape[1]] = src
        return out

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        x = img.astype(np.float32)
        # d2 BlendTransform semantics (Random{Brightness,Contrast,Saturation})
        if self.brightness != 1.0:
            x = x * self.brightness
        if self.contrast != 1.0:
            x = x.mean() * (1.0 - self.contrast) + x * self.contrast
        if self.saturation != 1.0 and x.ndim == 3:
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            x = gray[..., None] * (1.0 - self.saturation) + x * self.saturation
        x = np.clip(x, 0, 255).astype(np.uint8)
        return self._geo(x, INTER_LINEAR)

    def apply_mask(self, mask: np.ndarray) -> np.ndarray:
        return self._geo(mask.astype(np.uint8), INTER_NEAREST)


# backward-compat alias: the minimal whole-clip transform used by the
# eval mapper (flip/scale/crop shared; no rotation/color)
@dataclass
class ClipTransform:
    flip: bool
    scale: float
    crop_y: int
    crop_x: int
    out_size: Tuple[int, int]

    def _frame(self) -> FrameTransform:
        return FrameTransform(
            flip=self.flip, out_size=self.out_size, scale=self.scale,
            crop_y=self.crop_y, crop_x=self.crop_x,
        )

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return self._frame().apply_image(img)

    def apply_mask(self, mask: np.ndarray) -> np.ndarray:
        return self._frame().apply_mask(mask)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


@dataclass
class TrainAugConfig:
    """Training augmentation knobs (reference build_augmentation)."""

    image_size: int = 1024
    min_scale: float = 0.25
    max_scale: float = 4.0
    flip_prob: float = 0.5
    # pseudo-video extras (cfg.INPUT.PSEUDO.AUGMENTATIONS)
    color_jitter: bool = False
    rotation: bool = False
    rotation_angle: Tuple[float, float] = (-15.0, 15.0)
    rotation_center: Tuple[Tuple[float, float], Tuple[float, float]] = ((0.4, 0.4), (0.6, 0.6))
    rotation_reverse_prob: float = 0.5
    pseudo_temporal_shift: bool = True


def sample_clip_transforms(
    rng: np.random.RandomState,
    image_hw: Tuple[int, int],
    num_frames: int,
    cfg: TrainAugConfig = TrainAugConfig(),
) -> List[FrameTransform]:
    """Sample the reference training recipe for one clip of stills with
    identical (h, w).  Returns one FrameTransform per frame."""
    h, w = image_hw
    T = num_frames
    S = cfg.image_size
    flip = bool(rng.rand() < cfg.flip_prob)

    # rotation: per-frame sorted angle progression, shared center
    angles = np.zeros(T, np.float32)
    center = None
    if cfg.rotation:
        angles = np.sort(rng.uniform(*cfg.rotation_angle, size=T))
        if rng.rand() < cfg.rotation_reverse_prob:
            angles = angles[::-1]
        (cx0, cy0), (cx1, cy1) = cfg.rotation_center
        center = (float(rng.uniform(cx0, cx1)), float(rng.uniform(cy0, cy1)))

    # FixedSizeCropClip base offset fraction is shared; the actual pixel
    # offset depends on each frame's own post-resize size
    base_frac = rng.uniform(0.0, 1.0)

    out: List[FrameTransform] = []
    base_offset = None
    for t in range(T):
        b = c = s = 1.0
        if cfg.color_jitter:
            b = float(rng.uniform(0.9, 1.1))
            c = float(rng.uniform(0.9, 1.1))
            s = float(rng.uniform(0.9, 1.1))
        # ResizeScale, sampled per frame (reference uses plain T.ResizeScale)
        random_scale = rng.uniform(cfg.min_scale, cfg.max_scale)
        output_scale = min(S * random_scale / h, S * random_scale / w)
        nh, nw = int(round(h * output_scale)), int(round(w * output_scale))

        max_off = np.maximum(np.array([nh - S, nw - S]), 0)
        if t == 0 or base_offset is None:
            offset = np.round(max_off * base_frac).astype(int)
            base_offset = offset
        else:
            shift_range = np.minimum(max_off, (0.1 * np.array([S, S])).astype(int))
            shift = ((rng.rand(2) * 2 - 1) * shift_range).astype(int)
            offset = np.clip(base_offset + shift, 0, max_off)
        out.append(
            FrameTransform(
                flip=flip, out_size=(S, S), scale=output_scale,
                crop_y=int(offset[0]), crop_x=int(offset[1]),
                brightness=b, contrast=c, saturation=s,
                rot_angle=float(angles[t]), rot_center=center,
            )
        )
    return out


def sample_lsj_transform(
    rng: np.random.RandomState,
    image_hw: Tuple[int, int],
    image_size: int = 1024,
    min_scale: float = 0.25,
    max_scale: float = 4.0,
    flip_prob: float = 0.5,
) -> ClipTransform:
    """Minimal whole-clip LSJ (flip + ResizeScale + FixedSizeCrop with a
    single shared transform; subset of sample_clip_transforms kept for
    whole-clip callers)."""
    h, w = image_hw
    scale = rng.uniform(min_scale, max_scale)
    r = min(image_size * scale / h, image_size * scale / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    max_cy = max(nh - image_size, 0)
    max_cx = max(nw - image_size, 0)
    return ClipTransform(
        flip=bool(rng.rand() < flip_prob),
        scale=r,
        crop_y=int(rng.randint(0, max_cy + 1)),
        crop_x=int(rng.randint(0, max_cx + 1)),
        out_size=(image_size, image_size),
    )


def resize_shortest_edge(
    image_hw: Tuple[int, int], short: int = 640, max_size: int = 1333,
    size_divisibility: int = 32,
) -> ClipTransform:
    """Deterministic eval transform: shortest edge -> ``short``, padded
    to divisibility (reference eval path: ResizeShortestEdgeClip)."""
    h, w = image_hw
    r = short / min(h, w)
    if max(h, w) * r > max_size:
        r = max_size / max(h, w)
    nh, nw = int(round(h * r)), int(round(w * r))
    pad = lambda v: ((v + size_divisibility - 1) // size_divisibility) * size_divisibility
    return ClipTransform(flip=False, scale=r, crop_y=0, crop_x=0, out_size=(pad(nh), pad(nw)))


def transformed_image_size(t: ClipTransform, image_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Actual (unpadded) content size after the transform."""
    h, w = image_hw
    return (
        min(int(round(h * t.scale)) - t.crop_y, t.out_size[0]),
        min(int(round(w * t.scale)) - t.crop_x, t.out_size[1]),
    )
