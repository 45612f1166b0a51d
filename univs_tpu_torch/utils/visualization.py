"""Result visualization + VOS palette PNG writers (the port's copy of
``univs_tpu/utils/visualization.py``, which the port may not import).

Rebuild of the reference's visualization/demo layer
(reference: univs/inference/visualization.py, demo/predictor.py,
save_vos_results PNG palette output — inference_video_vos.py:622-670).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# DAVIS-style palette (index 0 = background)
_DAVIS_PALETTE = np.array(
    [[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
     [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0], [191, 0, 0],
     [64, 128, 0], [191, 128, 0], [64, 0, 128], [191, 0, 128], [64, 128, 128],
     [191, 128, 128], [0, 64, 0], [128, 64, 0], [0, 191, 0], [128, 191, 0]],
    np.uint8,
)


def color_for(idx: int) -> np.ndarray:
    if idx < len(_DAVIS_PALETTE):
        return _DAVIS_PALETTE[idx]
    rng = np.random.RandomState(idx)
    return rng.randint(0, 255, 3).astype(np.uint8)


def save_vos_png(labels: np.ndarray, path: str):
    """Per-frame label map [H, W] -> palette PNG (DAVIS/YTVOS format,
    reference: save_vos_results palette writer)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = Image.fromarray(labels.astype(np.uint8), mode="P")
    pal = np.zeros((256, 3), np.uint8)
    pal[: len(_DAVIS_PALETTE)] = _DAVIS_PALETTE
    img.putpalette(pal.reshape(-1).tolist())
    img.save(path)


def save_vos_video(labels: np.ndarray, out_dir: str, file_names: Optional[Sequence[str]] = None):
    """[V, H, W] label maps -> per-frame PNGs named after the inputs."""
    V = labels.shape[0]
    for t in range(V):
        name = (
            os.path.splitext(os.path.basename(file_names[t]))[0] + ".png"
            if file_names else f"{t:05d}.png"
        )
        save_vos_png(labels[t], os.path.join(out_dir, name))


def overlay_instances(frame: np.ndarray, masks: Sequence[np.ndarray],
                      labels: Optional[Sequence[str]] = None, alpha: float = 0.5) -> np.ndarray:
    """Blend instance masks over an RGB frame (demo overlay,
    reference: visualize_results_vis)."""
    out = frame.astype(np.float32).copy()
    for i, m in enumerate(masks):
        color = color_for(i + 1).astype(np.float32)
        mm = m.astype(bool)
        out[mm] = out[mm] * (1 - alpha) + color * alpha
    return out.clip(0, 255).astype(np.uint8)


def write_video(frames: Sequence[np.ndarray], path: str, fps: int = 10):
    """Frames -> video file via cv2 (reference writes .avi overlays)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
