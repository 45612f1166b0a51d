"""The plain laws of the three encoder kernels (multi-scale deformable
sampling, its offset / weight rows, and the fused residual + LayerNorm +
FFN + LayerNorm tail), frozen from the port's ``ops/`` as plain PyTorch:
no kernel, no device branch.  In float32 every rounding to the input
dtype is a no-op, so the reference computes each law in float32."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _level_starts(spatial_shapes):
    starts = [0]
    for (h, w) in spatial_shapes:
        starts.append(starts[-1] + h * w)
    return starts


def msda_sample(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                loc: torch.Tensor) -> torch.Tensor:
    """value [N, S, M, D]; loc [N, Lq, M, L, P, 3] (x, y pixel coords,
    weight) -> [N, Lq, M*D]: the bilinear weighted sum over every level,
    zero outside a level's border."""
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    starts = _level_starts(spatial_shapes)
    assert starts[-1] == S and L == len(spatial_shapes)
    f32 = torch.float32
    out = torch.zeros((N, M, Lq, D), dtype=f32, device=value.device)
    xs = loc[..., 0].to(f32).permute(0, 2, 1, 3, 4)
    ys = loc[..., 1].to(f32).permute(0, 2, 1, 3, 4)
    ws = loc[..., 2].to(f32).permute(0, 2, 1, 3, 4)
    for lid, (h, w) in enumerate(spatial_shapes):
        vl = value[:, starts[lid]:starts[lid + 1]].to(f32).permute(0, 2, 1, 3)  # [N, M, hw, D]
        x, y, wa = xs[:, :, :, lid], ys[:, :, :, lid], ws[:, :, :, lid]  # [N, M, Lq, P]
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                xi, yi = x0 + dx, y0 + dy
                inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).to(torch.int64)
                g = torch.gather(vl, 2, idx.reshape(N, M, Lq * P, 1).expand(N, M, Lq * P, D))
                cw = (wx * wy * wa * inb.to(f32)).reshape(N, M, Lq * P, 1)
                out += (g * cw).reshape(N, M, Lq, P, D).sum(3)
    return out.permute(0, 2, 1, 3).reshape(N, Lq, M * D).to(value.dtype)


def reference_grid(spatial_shapes, device):
    """Per-query (ref_x, ref_y) in [0, 1]: pixel centres of each query's
    own level, level-major raster order."""
    xs, ys = [], []
    for (h, w) in spatial_shapes:
        s = torch.arange(h * w, device=device)
        xs.append(((s % w).to(torch.float32) + 0.5) / w)
        ys.append(((s // w).to(torch.float32) + 0.5) / h)
    return torch.cat(xs), torch.cat(ys)


def msda_rows(query, wo, bo, wa, ba, spatial_shapes, n_heads: int, n_points: int) -> torch.Tensor:
    """Offsets and softmaxed weights from the query tokens, as pixel
    coordinates: [N, Lq, M, L, P, 3] float32."""
    N, Lq, C = query.shape
    M, P, L = n_heads, n_points, len(spatial_shapes)
    f32 = torch.float32
    q = query.to(f32)
    offs = (q @ wo.to(f32) + bo.to(f32)).reshape(N, Lq, M, L, P, 2)
    logits = (q @ wa.to(f32) + ba.to(f32)).reshape(N, Lq, M, L * P)
    attn = torch.softmax(logits, dim=-1).reshape(N, Lq, M, L, P)
    ref_x, ref_y = reference_grid(spatial_shapes, query.device)
    size_w = torch.tensor([w for _, w in spatial_shapes], dtype=f32, device=query.device)
    size_h = torch.tensor([h for h, _ in spatial_shapes], dtype=f32, device=query.device)
    x = ref_x[None, :, None, None, None] * size_w[None, None, None, :, None] + offs[..., 0] - 0.5
    y = ref_y[None, :, None, None, None] * size_h[None, None, None, :, None] + offs[..., 1] - 0.5
    return torch.stack([x, y, attn], dim=-1)


def _ln(z, g, c, eps):
    mu = z.mean(-1, keepdim=True)
    zc = z - mu
    var = (zc * zc).mean(-1, keepdim=True)
    return zc * torch.rsqrt(var + eps) * g.to(torch.float32) + c.to(torch.float32)


def fused_ffn_ln(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps: float = 1e-5):
    """src / attn_out [N, S, C], w1 [C, F], w2 [F, C] -> [N, S, C]:
    LN(src + attn), then LN(u + FFN(u))."""
    dt = src.dtype
    f32 = torch.float32
    u = _ln(src.to(f32) + attn_out.to(f32), g1, c1, eps)
    y1 = torch.relu(u.to(dt).to(f32) @ w1.to(f32) + b1.to(f32))
    y2 = y1.to(dt).to(f32) @ w2.to(f32)
    return _ln(u + y2 + b2.to(f32), g2, c2, eps).to(dt)
