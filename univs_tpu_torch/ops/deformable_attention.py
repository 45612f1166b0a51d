"""Multi-scale deformable attention sampling (counterpart of
``univs_tpu/ops/deformable_attention.py``).

Semantics (the reference's ``ms_deform_attn_core_pytorch``,
ops/functions/ms_deform_attn_func.py:52-72, and the JAX package's
``_msda_gather``): per level, bilinear sampling with ``grid_sample``
semantics (align_corners=False, zero padding) at pixel coordinates
``loc * size - 0.5``, then a weighted sum over levels and points,
accumulated in float32; the output has the value's dtype.

Three pieces:

- ``msda_sample_plain`` — the plain law over (x, y, w) rows;
- ``msda_sample_cuda`` — kernel A (``csrc/msda_sample.cu``), one launch
  for all levels;
- ``msda_sample`` dispatches on the value's device (CPU -> plain law,
  CUDA -> kernel A or raise), and ``ms_deform_attn`` keeps the JAX
  package's API (normalized sampling locations + attention weights).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from univs_tpu_torch.ops import kernels


def _level_starts(spatial_shapes):
    starts = [0]
    for (h, w) in spatial_shapes:
        starts.append(starts[-1] + h * w)
    return starts


def msda_sample_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                      loc: torch.Tensor) -> torch.Tensor:
    """value [N, S, M, D]; loc [N, Lq, M, L, P, 3] (x, y pixel coords,
    weight) -> [N, Lq, M*D] in value's dtype, float32 accumulation."""
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    starts = _level_starts(spatial_shapes)
    assert starts[-1] == S and L == len(spatial_shapes)
    f32 = torch.float32
    out = torch.zeros((N, M, Lq, D), dtype=f32, device=value.device)
    # head-major sample layout [N, M, Lq, L, P]
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


def msda_sample_cuda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                     loc: torch.Tensor) -> torch.Tensor:
    """Kernel A on the card: value [N, S, M, D] float32/bfloat16, loc
    [N, Lq, M, L, P, 3] float32, both contiguous -> [N, Lq, M*D]."""
    N, S, M, D = value.shape
    if loc.dim() != 6 or loc.shape[0] != N or loc.shape[2] != M or loc.shape[-1] != 3:
        raise ValueError(f"msda_sample: loc {tuple(loc.shape)} does not match value "
                         f"{tuple(value.shape)}")
    L, P, Lq = loc.shape[3], loc.shape[4], loc.shape[1]
    if L != len(spatial_shapes) or _level_starts(spatial_shapes)[-1] != S:
        raise ValueError("msda_sample: spatial shapes do not match value / loc")
    if loc.dtype != torch.float32:
        raise TypeError("msda_sample: loc must be float32")
    kernels.require_cuda("msda_sample", value, loc)
    code = kernels.dtype_code(value)
    out = torch.empty((N, Lq, M * D), dtype=value.dtype, device=value.device)
    fn = kernels.lib("msda_sample").msda_sample_launch
    err = fn(code, value.data_ptr(), loc.data_ptr(), out.data_ptr(), N, S, Lq, M, D, P, L,
             kernels.shapes_arg(spatial_shapes), kernels.stream_arg(value.device))
    kernels.check("msda_sample", err)
    kernels.LAUNCHES["msda_sample"] += 1
    return out


def msda_sample(value: torch.Tensor, spatial_shapes, loc: torch.Tensor) -> torch.Tensor:
    """[N, Lq, M*D]: plain law on the CPU, kernel A on CUDA."""
    if value.is_cuda:
        return msda_sample_cuda(value, spatial_shapes, loc)
    return msda_sample_plain(value, spatial_shapes, loc)


def locations_to_rows(spatial_shapes, sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """JAX-API inputs -> kernel rows: locations [N, Lq, M, L, P, 2] in
    [0, 1] (x, y) and weights [N, Lq, M, L, P] -> loc [N, Lq, M, L, P, 3]
    float32 with pixel coords ``loc * size - 0.5``."""
    f32 = torch.float32
    dev = sampling_locations.device
    size_w = torch.tensor([w for _, w in spatial_shapes], dtype=f32, device=dev)
    size_h = torch.tensor([h for h, _ in spatial_shapes], dtype=f32, device=dev)
    x = sampling_locations[..., 0].to(f32) * size_w[:, None] - 0.5
    y = sampling_locations[..., 1].to(f32) * size_h[:, None] - 0.5
    return torch.stack([x, y, attention_weights.to(f32)], dim=-1).contiguous()


def ms_deform_attn(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``ms_deform_attn`` contract: value [N, S, M, D],
    sampling_locations [N, Lq, M, L, P, 2] in [0, 1], attention_weights
    [N, Lq, M, L, P] (softmaxed) -> [N, Lq, M*D]."""
    loc = locations_to_rows(spatial_shapes, sampling_locations, attention_weights)
    return msda_sample(value, spatial_shapes, loc)
