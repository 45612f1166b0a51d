"""Microbenchmark of pixel-decoder pieces (counterpart of the JAX package's
``tools/profile_gather.py``, with its printed lines), at the encoder's
shape: N=5 frames, the 640x960 levels 80x120 / 40x60 / 20x30, M=8 heads,
D=32, 4 points:

- the plain ``take_along`` gather (``torch.gather`` + the weighted sum);
- ``ms_deform_attn`` through kernel A (float32);
- one ``MSDeformAttnLayer`` in bf16 (kernels B and A);
- the 2-D sine PEs of the 1/8 and 1/16 levels;
- GroupNorm (32 groups) on [N, 80, 120, 256] bf16 tokens.

Each is timed with CUDA events over ``--iters`` calls after ``--warmup``
and a synchronise (the JAX tool forces its sync by fetching a scalar).

    python -m univs_tpu_torch.tools.profile_gather [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

FULL = dict(N=5, M=8, D=32, P=4, shapes=((80, 120), (40, 60), (20, 30)))
TINY = dict(N=1, M=2, D=8, P=2, shapes=((8, 12), (4, 6), (2, 3)))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--tiny", action="store_true", help="a tiny geometry (N=1, M=2, D=8)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> dict:
    from univs_tpu_torch import tools
    from univs_tpu_torch.models.pixel_decoder import MSDeformAttnLayer
    from univs_tpu_torch.ops.deformable_attention import ms_deform_attn
    from univs_tpu_torch.ops.position_encoding import SinePositionEncoding3D
    from univs_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    g = TINY if args.tiny else FULL
    N, M, D, P, shapes = g["N"], g["M"], g["D"], g["P"], g["shapes"]
    L = len(shapes)
    S = Lq = sum(h * w for h, w in shapes)
    K = Lq * L * P
    C = M * D
    rng = np.random.RandomState(0)
    t = lambda a, dtype=torch.float32: torch.as_tensor(a).to(device=dev, dtype=dtype)
    time = lambda fn: tools.stage_ms(fn, dev, args.iters, args.warmup)
    out = {}

    v = t(rng.randn(N, M, S, D))
    idx = t(rng.randint(0, S, (N, M, K)), torch.int64)
    w = t(rng.rand(N, M, K))

    def take_along():
        gathered = torch.gather(v, 2, idx[..., None].expand(N, M, K, D))
        return torch.einsum("nmkd,nmk->nmd", gathered, w)

    out["take_along_ms"] = time(take_along)
    print(f"gather take_along: {out['take_along_ms']:.1f} ms", flush=True)
    del v, idx, w

    val = t(rng.randn(N, S, M, D))
    loc = t(rng.rand(N, Lq, M, L, P, 2))
    attw = t(rng.rand(N, Lq, M, L, P)) / (L * P)
    out["ms_deform_attn_ms"] = time(lambda: ms_deform_attn(val, shapes, loc, attw))
    print(f"ms_deform_attn full: {out['ms_deform_attn_ms']:.1f} ms", flush=True)
    del val, loc, attw

    from univs_tpu_torch.utils import weights

    layer = MSDeformAttnLayer(d_model=C, n_levels=L, n_heads=M, n_points=P)
    weights.init_params(layer, 0)
    layer = layer.to(device=dev, dtype=torch.bfloat16)
    q = t(rng.randn(N, S, C), torch.bfloat16)
    out["layer_ms"] = time(lambda: layer(q, q, shapes))
    print(f"MSDeformAttnLayer: {out['layer_ms']:.1f} ms", flush=True)
    del q

    pe = SinePositionEncoding3D(num_pos_feats=C // 2, normalize=True)
    (h0, w0), (h1, w1) = shapes[0], shapes[1]
    out["pe_ms"] = time(lambda: pe.grid2d(h0, w0, dev).sum() + pe.grid2d(h1, w1, dev).sum())
    print(f"grid2d PEs: {out['pe_ms']:.1f} ms", flush=True)

    gn = torch.nn.GroupNorm(min(32, C), C).to(device=dev, dtype=torch.bfloat16)
    x = t(rng.randn(N, h0, w0, C), torch.bfloat16)
    out["groupnorm_ms"] = time(lambda: F.group_norm(x.permute(0, 3, 1, 2), gn.num_groups,
                                                    gn.weight, gn.bias, gn.eps))
    print(f"GroupNorm: {out['groupnorm_ms']:.1f} ms", flush=True)
    out["calls"] = args.iters + args.warmup
    return out


if __name__ == "__main__":
    main()
