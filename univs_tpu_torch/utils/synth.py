"""Synthetic videos for training batches, demos and tests (the port's
copy of ``univs_tpu/utils/synth.py``; numpy only).

Persistent moving Gaussian blobs rather than noise: the objects persist
over frames, so tracking and admission see object-like inputs, and a
mask of the brightest blob makes a seeded training target.
"""

from __future__ import annotations

import numpy as np


def synth_blob_video(V: int, h: int, w: int, n_blobs: int = 24,
                     seed: int = 0) -> np.ndarray:
    """[V, h, w, 3] uint8 video of persistent moving Gaussian blobs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy0 = rng.rand(n_blobs) * h
    cx0 = rng.rand(n_blobs) * w
    vy = (rng.rand(n_blobs) - 0.5) * 12
    vx = (rng.rand(n_blobs) - 0.5) * 12
    sig = 20 + rng.rand(n_blobs) * 40
    col = rng.rand(n_blobs, 3) * 220 + 35
    video = np.zeros((V, h, w, 3), np.uint8)
    for t in range(V):
        acc = np.zeros((h, w, 3), np.float32)
        cy = (cy0 + vy * t) % h
        cx = (cx0 + vx * t) % w
        for b in range(n_blobs):
            g = np.exp(-(((yy - cy[b]) / sig[b]) ** 2
                         + ((xx - cx[b]) / sig[b]) ** 2))
            acc += g[..., None] * col[b]
        video[t] = np.clip(acc, 0, 255).astype(np.uint8)
    return video
