"""Benchmark: streaming VIS driver FPS at realistic entity occupancy
(counterpart of the JAX package's ``tools/bench_occupancy.py``).

The standard bench video (random weights) admits about one entity of 60
slots, so the drain's device-to-host bytes and the host-side RLE work run
far below production scale (YouTube-VIS videos carry ~10-60 tracked
entities).  This benchmark floors the admission gates (newly / cls /
consistency -> 0, NMS -> off) so that the detection path admits its top-k
candidates and the pool fills toward capacity, on ``synth_blob_video``
(24 blobs), and times the pipelined driver (``start_vis`` /
``finish_vis``, the next video uploaded behind this one's compute) at that
occupancy and, beside it, at the standard gates on the same model and
video: the FPS difference is the drain + RLE cost of the entities.

    python -m univs_tpu_torch.tools.bench_occupancy \\
        [--height 640 --width 960 --frames 30 --dtype bfloat16 --device cuda]

UniVS-R50 with seeded weights, K=40.  The size and dtype come from the
flags alone (the JAX tool drops to 128x192 float32 off the TPU; this one
runs what it is asked, on the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

K = 40


def log(m):
    print(m, flush=True)


def floored(base):
    """``base`` with the admission gates floored: nothing matches an
    existing entity (newly 2.0), the class and consistency gates at 0 and
    NMS above 1 (random weights give near-identical masks, which any real
    NMS threshold collapses to one entity)."""
    return dataclasses.replace(base, inference=dataclasses.replace(
        base.inference, apply_cls_thres=0.0, newly_entity_thres=2.0,
        consistency_thres=(0.0, 0.0), nms_thres=1.5))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--frames", type=int, default=30, help="frames a video (V)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--iters", type=int, default=3, help="videos through the pipelined driver")
    p.add_argument("--tiny", action="store_true", help="the tiny test config")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


def pipelined(driver, video, cls_emb, iters: int, device):
    """s a video of ``iters`` videos through ``start_vis`` / ``finish_vis``
    (the first already on the device), and the last video's results."""
    dev_video = torch.as_tensor(video, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    hd = driver.start_vis(dev_video, cls_emb, next_frames=video)
    for _ in range(iters - 1):
        hd_next = driver.start_vis(hd["next_frames_device"], cls_emb, next_frames=video)
        driver.finish_vis(hd)
        hd = hd_next
    results = driver.finish_vis(hd)
    return (time.perf_counter() - t0) / iters, results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from univs_tpu_torch.config import UniVSConfig, tiny_test_config
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.utils.device import resolve_device
    from univs_tpu_torch.utils.synth import synth_blob_video

    args = parse_args(argv)
    device = resolve_device(args.device)
    base = (tiny_test_config() if args.tiny else UniVSConfig()).replace(dtype=args.dtype)
    cfg = floored(base)
    h, w, V = args.height, args.width, args.frames
    rng = np.random.RandomState(0)
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32),
                              device=device)
    model = build_model(cfg, None, seed=0, device=device)
    video = synth_blob_video(V, h, w, n_blobs=24, seed=0)
    capacity = cfg.inference.max_num_instances
    driver = EntityDriver(cfg, model, num_classes=K, capacity=capacity, device=device)

    log("warm-up...")
    results = driver.run_vis(video, cls_emb)
    log(f"occupancy: {len(results)} / {capacity} slots")
    dt, results = pipelined(driver, video, cls_emb, args.iters, device)
    log(f"pipelined driver: {dt:.3f} s/video = {V / dt:.2f} FPS at "
        f"E={len(results)} occupancy ({device.type})")

    standard = EntityDriver(base, model, num_classes=K, capacity=capacity, device=device)
    standard.run_vis(video, cls_emb)
    dt_std, results_std = pipelined(standard, video, cls_emb, args.iters, device)
    log(f"standard gates: {dt_std:.3f} s/video = {V / dt_std:.2f} FPS at "
        f"E={len(results_std)} occupancy ({device.type})")
    return dict(entities=len(results), capacity=capacity, s_per_video=dt, fps=V / dt,
                entities_standard=len(results_std), s_per_video_standard=dt_std,
                fps_standard=V / dt_std, frames=V, height=h, width=w)


if __name__ == "__main__":
    main()
