"""Batched multi-video VIS serving (counterpart of
``univs_tpu/inference/serving.py``).

``BatchedVISServer`` decodes B videos in lockstep.  The window encode
runs the backbone once per video's window, so each video's features are
those of a lone encode whatever the batch, and the pixel decoder once
over the B x window frames, so kernels A, B and C run once per encoder
layer for the whole batch.  The JAX package ``vmap``s the clip step, the
pool shift and the emission over videos; the port's clip step is eager
with host decisions, so it loops over the videos, each with its own
memory pool, through the same ``entity_clip_step`` / ``memory_pool``
laws as ``EntityDriver``.

Contract (the JAX package's): all videos share one padded resolution;
shorter videos repeat their last frame (their frame indices clamp at
their true length) and their results are cut to that length.  The
schedule is the JAX server's: a window is encoded when ``i + T`` passes
it, the emission follows the longest video.  Videos of the longest
length get exactly ``EntityDriver.run_vis``'s results; a shorter video's
padded clips may still update its pool's scores, the JAX package's
documented serving deviation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from univs_tpu_torch.config import UniVSConfig
from univs_tpu_torch.inference.driver import (
    EntityDriver,
    _upsample_threshold_pack,
    assemble_vis_results,
)
from univs_tpu_torch.inference.entity import entity_clip_step


class BatchedVISServer:
    """Lockstep VIS over a batch of videos (throughput serving mode).

    Args:
        cfg: UniVSConfig
        params: a ``UniVSModel`` already built, its state_dict, or None
            for the port's seeded init (``seed``)
        num_classes: K of the category slice
        capacity: entity slots per video
        batch_size: videos decoded per dispatch
        device: None -> the card (raises without one); "cpu" explicitly
    """

    def __init__(self, cfg: UniVSConfig, params=None, num_classes: int = 1, capacity: int = 40,
                 batch_size: int = 2, device=None, seed: int = 0):
        self.driver = EntityDriver(cfg, params, num_classes=num_classes, capacity=capacity,
                                   device=device, seed=seed)
        # the JAX server's schedule: a window is encoded when i + T passes it
        self.driver.tail_clamped_encode = False
        self.cfg = cfg
        self.model = self.driver.model
        self.device = self.driver.device
        self.num_classes = num_classes
        self.capacity = capacity
        self.batch_size = batch_size

    def num_window_encodes(self, V: int) -> int:
        return self.driver.num_window_encodes(V)

    @torch.no_grad()
    def _stream_batch(self, frames_b, lengths: Sequence[int], cls_emb) -> Dict:
        """frames_b [B, V, H, W, 3] (tail frames repeated per video; host or
        device) -> per
        video the fp16 windows, their starts, score snapshots and the
        final pool.  The driver's clip loop over the B videos: one window
        encode for the batch, each video's clip step on its own pool at
        frame indices clamped to its length."""
        B, V, H, W = frames_b.shape[:4]
        d = self.driver
        dev = self.device
        pools = [d._new_pool(self.capacity, self.num_classes, H, W) for _ in range(B)]
        cls_emb = torch.as_tensor(cls_emb).to(device=dev, dtype=torch.float32)
        emitted: List[List[torch.Tensor]] = [[] for _ in range(B)]
        emit_scores: List[List[torch.Tensor]] = [[] for _ in range(B)]
        emit_starts: List[int] = []
        lengths = np.asarray(lengths)

        def clip_step(b, feats, c):
            fi = np.minimum(c["clip_idx"], lengths[b] - 1)
            entity_clip_step(d._modules, feats, pools[b], fi, c["offset"], c["i"] == 0, cls_emb,
                             d.cc)

        def on_emit(b, start, n_out):
            win, scores, _ = d._emit(pools[b], n_out, divide=True)
            emitted[b].append(win)
            emit_scores[b].append(scores)
            if b == 0:
                emit_starts.append(start)

        d._clip_loop(torch.as_tensor(frames_b).to(d.frames_device), pools, clip_step, on_emit)
        return dict(emitted=emitted, emit_scores=emit_scores, emit_starts=emit_starts,
                    pools=pools)

    def run_vis(self, videos: Sequence[np.ndarray], cls_emb,
                image_sizes: Optional[Sequence] = None,
                out_sizes: Optional[Sequence] = None) -> List[List[Dict]]:
        """videos: B arrays [V_b, H, W, 3] at ONE padded resolution ->
        per video the per-entity result dicts of ``EntityDriver.run_vis``
        (per-frame RLEs and class scores), cut to each video's length."""
        B = len(videos)
        if B != self.batch_size:
            raise ValueError(f"run_vis takes batch_size={self.batch_size} videos, got {B}")
        H, W = videos[0].shape[1:3]
        if any(v.shape[1:3] != (H, W) for v in videos):
            raise ValueError("every video of a batch must share one padded resolution")
        lengths = [v.shape[0] for v in videos]
        V = max(lengths)
        frames_b = np.stack([v[np.minimum(np.arange(V), v.shape[0] - 1)] for v in videos])
        return self.run_frames(frames_b, lengths, cls_emb, image_sizes, out_sizes)

    def run_frames(self, frames_b, lengths: Sequence[int], cls_emb,
                   image_sizes: Optional[Sequence] = None,
                   out_sizes: Optional[Sequence] = None) -> List[List[Dict]]:
        """``run_vis`` on the batch already stacked: ``frames_b`` [B, V, H, W,
        3] (each video's tail frames repeated, as ``run_vis`` pads them), a
        host array or a tensor already on the device (served frames are
        uploaded ahead of the compute), and each video's true length."""
        B, _, H, W = frames_b.shape[:4]
        if B != self.batch_size:
            raise ValueError(f"run_frames takes batch_size={self.batch_size} videos, got {B}")
        h = self._stream_batch(frames_b, lengths, cls_emb)
        out = []
        with torch.no_grad():
            for b in range(B):
                image_size = tuple(image_sizes[b]) if image_sizes else (H, W)
                out_size = tuple(out_sizes[b]) if out_sizes else image_size
                pool = h["pools"][b]
                rows = np.flatnonzero(pool.valid.cpu().numpy())
                if rows.size:
                    idx = torch.as_tensor(rows, device=self.device)
                    packed = [_upsample_threshold_pack(m[idx], image_size, out_size, (H, W))
                              .cpu().numpy() for m in h["emitted"][b]]
                else:
                    packed = [np.zeros((0, m.shape[1], out_size[0], (out_size[1] + 7) // 8),
                                       np.uint8) for m in h["emitted"][b]]
                out.append(assemble_vis_results(
                    packed, h["emit_starts"], [s.cpu().numpy() for s in h["emit_scores"][b]],
                    pool.valid.cpu().numpy(), pool.quality_sum.cpu().numpy(), lengths[b],
                    out_size, rows))
        return out
