"""Benchmark: lockstep-batched VIS serving throughput vs batch size
(counterpart of the JAX package's ``tools/bench_serving.py``).

Measures the FULL ``BatchedVISServer`` pipeline (frames in -> per-video
entity dicts out) at B in {1, 2, 4, 8} (or the batch sizes given),
reporting per-card throughput: B * V / wall frames/s and B / wall
videos/s.  Frames are uploaded to the device before timing: steady-state
serving overlaps ingest with compute (``EntityDriver.start_vis``).

    python -m univs_tpu_torch.tools.bench_serving [B ...] \\
        [--height 640 --width 960 --frames 30 --dtype bfloat16 --device cuda]

UniVS-R50 with seeded weights, K=40 classes, 40 entity slots.  The size
and dtype come from the flags alone (the JAX tool drops to 128x192
float32 off the TPU; this one runs what it is asked, on the card unless
``--device cpu``).  A batch size that runs out of device memory is
recorded as failed, as the JAX tool records it; any other error raises.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

K, E = 40, 40


def log(m):
    print(m, flush=True)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("batch_sizes", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--frames", type=int, default=30, help="frames a video (V)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--iters", type=int, default=3, help="timed runs a batch size")
    p.add_argument("--tiny", action="store_true", help="the tiny test config")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


def bench_config(args):
    from univs_tpu_torch.config import UniVSConfig, tiny_test_config

    return (tiny_test_config() if args.tiny else UniVSConfig()).replace(dtype=args.dtype)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    from univs_tpu_torch.inference.serving import BatchedVISServer
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = bench_config(args)
    h, w, V = args.height, args.width, args.frames
    rng = np.random.RandomState(0)
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32),
                              device=device)
    model = build_model(cfg, None, seed=0, device=device)
    video = (rng.rand(V, h, w, 3) * 255).astype(np.uint8)

    rows = []
    for B in args.batch_sizes:
        try:
            srv = BatchedVISServer(cfg, model, num_classes=K, capacity=E, batch_size=B,
                                   device=device)
            frames_b = torch.as_tensor(video, device=device)[None].expand(B, *video.shape)
            lengths = [V] * B

            def run_once():
                return srv.run_frames(frames_b, lengths, cls_emb)

            log(f"B={B}: warm-up...")
            out = run_once()
            n_ent = sum(len(o) for o in out)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = run_once()
            dt = (time.perf_counter() - t0) / args.iters
            fps = B * V / dt
            rows.append(dict(B=B, s_per_batch=dt, fps=fps, videos_per_s=B / dt, entities=n_ent))
            log(f"B={B}: {dt:.3f} s/batch = {fps:.2f} frames/s per card, "
                f"{B / dt:.3f} videos/s ({n_ent} entities)")
        except torch.cuda.OutOfMemoryError as e:  # OOM at large B is a finding
            rows.append(dict(B=B, s_per_batch=None, fps=None, videos_per_s=None, entities=None))
            log(f"B={B}: FAILED ({type(e).__name__}: {str(e)[:200]})")
            torch.cuda.empty_cache()

    log("")
    log("| B | s/batch | per-card FPS | videos/s |")
    log("|---|---|---|---|")
    for r in rows:
        if r["s_per_batch"] is None:
            log(f"| {r['B']} | OOM | — | — |")
        else:
            log(f"| {r['B']} | {r['s_per_batch']:.2f} | {r['fps']:.2f} | "
                f"{r['videos_per_s']:.3f} |")
    return rows


if __name__ == "__main__":
    main()
