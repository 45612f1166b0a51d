"""Per-stage timing of the flagship forward (counterpart of the JAX
package's ``tools/profile_stages.py``, with its printed lines).

Three stages of UniVS-R50's detection forward on one clip [1, T, H, W]
(640x960, T=5, bf16, K=40, seeded weights): the backbone, the backbone +
pixel decoder (``encode_features``), and the full forward.  Each is timed
with CUDA events over ``--iters`` calls after ``--warmup`` and a
synchronise (the JAX tool forces its sync by fetching a scalar to the
host).

    python -m univs_tpu_torch.tools.profile_stages [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

K = 40


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--tiny", action="store_true", help="the tiny test config")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> dict:
    from univs_tpu_torch import tools
    from univs_tpu_torch.config import UniVSConfig, tiny_test_config
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.structures import TextPrompts
    from univs_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (tiny_test_config() if args.tiny else UniVSConfig()).replace(dtype=args.dtype)
    model = build_model(cfg, None, seed=0, device=device)
    b, t, h, w = 1, args.frames, args.height, args.width
    rng = np.random.RandomState(0)
    images = torch.as_tensor((rng.rand(b, t, h, w, 3) * 255).astype(np.float32), device=device)
    fi = torch.arange(t, device=device)[None]
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32),
                              device=device)
    tp = TextPrompts(embs=cls_emb[None, :, None, :],
                     valid=torch.ones((b, K), dtype=torch.bool, device=device))

    def backbone():
        return model.backbone(model.normalize(images).reshape(b * t, h, w, 3))

    def encode():
        return model.encode_features(images)

    def full():
        return model(images, fi, task="detection", text_prompts=tp, cls_emb=cls_emb)

    time = lambda fn: tools.stage_ms(fn, device, args.iters, args.warmup)
    t_bb = time(backbone)
    print(f"backbone: {t_bb:.1f} ms", flush=True)
    t_enc = time(encode)
    print(f"backbone+pixel_decoder: {t_enc:.1f} ms", flush=True)
    t_full = time(full)
    print(f"full forward: {t_full:.1f} ms -> FPS {t / (t_full / 1e3):.2f}", flush=True)
    return dict(backbone_ms=t_bb, encode_ms=t_enc, full_ms=t_full, fps=t / (t_full / 1e3),
                calls=args.iters + args.warmup, frames=t, height=h, width=w)


if __name__ == "__main__":
    main()
