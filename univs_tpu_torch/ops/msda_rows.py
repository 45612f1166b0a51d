"""Sampling rows of the deformable attention (counterpart of
``univs_tpu/ops/msda_rows.py``).

From the query tokens and the two Dense layers of ``MSDeformAttnLayer``
this computes, per (frame, query, head, level, point), the pixel
coordinates and the attention weight of one bilinear sample:

    offsets = q @ Wo + bo                 -> [N, Lq, M, L, P, 2]
    w       = softmax_{L*P}(q @ Wa + ba)  -> [N, Lq, M, L, P]
    x = ref_x * W_l + off_x - 0.5,  y = ref_y * H_l + off_y - 0.5

where (ref_x, ref_y) is the static pixel-centre grid point of the
query's own level (no padding masks — ``models/pixel_decoder.py``).
The result is ``loc [N, Lq, M, L, P, 3]`` float32 holding (x, y, w),
the layout kernel A (``ops/deformable_attention.py``) reads.

Weights are taken in the JAX layout ``[in, out]`` (a Dense kernel; the
transpose of ``nn.Linear.weight``).  ``msda_rows`` dispatches on the
query's device: a CPU tensor takes ``msda_rows_plain``, a CUDA tensor
launches kernel B (``csrc/msda_rows.cu``) or raises.

``msda_rows`` is differentiable as the JAX package's fused sampling is
(``_msf_bwd``, ``univs_tpu/ops/msda_rows.py:259-264``): the forward is the
kernel, the backward recomputes ``msda_rows_plain`` under autograd and
returns its vector-Jacobian product, each gradient in its input's dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from univs_tpu_torch.ops import kernels


def reference_grid(spatial_shapes: Sequence[Tuple[int, int]], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query (ref_x, ref_y) in [0, 1]: pixel centres of each query's
    own level, queries in level-major raster order -> two [Lq] tensors."""
    xs, ys = [], []
    for (h, w) in spatial_shapes:
        s = torch.arange(h * w, device=device)
        xs.append(((s % w).to(torch.float32) + 0.5) / w)
        ys.append(((s // w).to(torch.float32) + 0.5) / h)
    return torch.cat(xs), torch.cat(ys)


def msda_rows_plain(query, wo, bo, wa, ba, spatial_shapes, n_heads: int, n_points: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B: products of the compute-dtype
    inputs accumulated in float32, float32 biases, float32 result."""
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


def msda_rows_cuda(query, wo, bo, wa, ba, spatial_shapes, n_heads: int, n_points: int) -> torch.Tensor:
    """Kernel B on the card.  ``query`` [N, Lq, C] (contiguous) and the
    weights [C, out] share one dtype (float32 or bfloat16).  The kernel
    reads the weights in nn.Linear's ``[out, in]`` layout, so ``wo.t()``
    / ``wa.t()`` are made contiguous here (free when the caller passes
    ``linear.weight.t()``, as the pixel decoder does); the biases are
    cast to float32 here.  bf16 at 8 heads, 3 levels and 4 points with
    C % 32 == 0 (the full-width encoder) runs on the tensor cores."""
    N, Lq, C = query.shape
    M, P, L = n_heads, n_points, len(spatial_shapes)
    Da = M * L * P
    if tuple(wo.shape) != (C, 2 * Da) or tuple(wa.shape) != (C, Da):
        raise ValueError(f"msda_rows: weights {tuple(wo.shape)}, {tuple(wa.shape)} do not "
                         f"match C={C}, M*L*P={Da}")
    if wo.dtype != query.dtype or wa.dtype != query.dtype:
        raise TypeError("msda_rows: weights must have the query's dtype")
    if sum(h * w for h, w in spatial_shapes) != Lq:
        raise ValueError("msda_rows: Lq must equal the total pixel count of the levels")
    wo_k, wa_k = wo.t().contiguous(), wa.t().contiguous()  # [2*Da, C], [Da, C]
    bo32 = bo.to(torch.float32).contiguous()
    ba32 = ba.to(torch.float32).contiguous()
    kernels.require_cuda("msda_rows", query, wo_k, wa_k, bo32, ba32)
    code = kernels.dtype_code(query)
    loc = torch.empty((N, Lq, M, L, P, 3), dtype=torch.float32, device=query.device)
    fn = kernels.lib("msda_rows").msda_rows_launch
    err = fn(code, query.data_ptr(), wo_k.data_ptr(), bo32.data_ptr(), wa_k.data_ptr(),
             ba32.data_ptr(), loc.data_ptr(), N, Lq, C, M, P, L,
             kernels.shapes_arg(spatial_shapes), kernels.stream_arg(query.device))
    kernels.check("msda_rows", err)
    kernels.LAUNCHES["msda_rows"] += 1
    return loc


class _MsdaRows(torch.autograd.Function):
    """Kernel B forward (the plain law on the CPU); the backward is the
    vector-Jacobian product of ``msda_rows_plain``, recomputed."""

    @staticmethod
    def forward(ctx, query, wo, bo, wa, ba, spatial_shapes, n_heads, n_points):
        ctx.save_for_backward(query, wo, bo, wa, ba)
        ctx.args = (tuple(spatial_shapes), n_heads, n_points)
        if query.is_cuda:
            return msda_rows_cuda(query, wo, bo, wa, ba, spatial_shapes, n_heads, n_points)
        return msda_rows_plain(query, wo, bo, wa, ba, spatial_shapes, n_heads, n_points)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:5])]
        with torch.enable_grad():
            loc = msda_rows_plain(*inputs, *ctx.args)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(loc, wrt, g) if wrt else ())
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * 3


def msda_rows(query, wo, bo, wa, ba, spatial_shapes, n_heads: int, n_points: int) -> torch.Tensor:
    """``loc [N, Lq, M, L, P, 3]``: plain law on the CPU, kernel B on
    CUDA; differentiable in every tensor input."""
    return _MsdaRows.apply(query, wo, bo, wa, ba, spatial_shapes, n_heads, n_points)
