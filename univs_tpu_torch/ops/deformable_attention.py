"""Multi-scale deformable attention sampling (counterpart of
``univs_tpu/ops/deformable_attention.py``).

Semantics (the reference's ``ms_deform_attn_core_pytorch``,
ops/functions/ms_deform_attn_func.py:52-72, and the JAX package's
``_msda_gather``): per level, bilinear sampling with ``grid_sample``
semantics (align_corners=False, zero padding) at pixel coordinates
``loc * size - 0.5``, then a weighted sum over levels and points,
accumulated in float32; the output has the value's dtype.

Pieces:

- ``msda_sample_plain`` / ``msda_sample_cuda`` — the plain law over
  (x, y, w) rows and kernel A (``csrc/msda_sample.cu``), the counterpart
  of the 2-D and windowed tent kernels, one launch for all levels;
- ``msda_tent_base_plain`` / ``msda_tent_base_cuda`` — the base tent
  kernel's law with its rounding points (float32 / bfloat16 value or its
  int8 slab) and kernel D (``csrc/msda_tent_base.cu``);
  ``quantize_int8_slab`` makes the int8 slab and its scales;
- ``msda_sample`` / ``msda_tent_base`` dispatch on the value's device
  (CPU -> plain version, CUDA -> the kernel or raise);
- ``ms_deform_attn_tent`` and ``ms_deform_attn`` keep the JAX package's
  API (normalized sampling locations + attention weights, the ``impl``,
  ``int8_slab`` and ``level_impl`` options).  Forward only.

``msda_sample`` is differentiable as the JAX package's tent op is
(``_msda_tent_bwd``, ``univs_tpu/ops/deformable_attention.py:815-819``):
the forward is kernel A, the backward recomputes the gather law
``msda_sample_plain`` under autograd, one frame at a time on the card
(its corner gathers are ~0.35 GB each for four full-width frames), and
returns its vector-Jacobian product: the x / y lanes get gradient
through the bilinear fractions only (``floor`` has none, corners out of
bounds contribute 0), the weight lane the sampled values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    [N, Lq, M, L, P, 3] float32, both contiguous and 16-byte aligned ->
    [N, Lq, M*D].

    The kernel reads a head's channels as 16-byte pieces, one lane each,
    1, 2, 4 or 8 lanes a head: D in {8, 16, 32, 64} for bfloat16 and
    D in {4, 8, 16, 32} for float32 (the model's D=32 and the tiny
    config's D=8 in both).  Any other D raises."""
    N, S, M, D = value.shape
    if D * value.element_size() not in (16, 32, 64, 128):
        raise ValueError(f"msda_sample: head size D={D} in {value.dtype} is not 1, 2, 4 or 8 "
                         "16-byte pieces")
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


class _MsdaSample(torch.autograd.Function):
    """Kernel A forward (the plain law on the CPU); the backward is the
    vector-Jacobian product of ``msda_sample_plain``, recomputed."""

    @staticmethod
    def forward(ctx, value, loc, spatial_shapes):
        ctx.save_for_backward(value, loc)
        ctx.shapes = tuple(spatial_shapes)
        if value.is_cuda:
            return msda_sample_cuda(value, spatial_shapes, loc)
        return msda_sample_plain(value, spatial_shapes, loc)

    @staticmethod
    def backward(ctx, g):
        value, loc = ctx.saved_tensors
        need_v, need_l = ctx.needs_input_grad[:2]
        gv = torch.zeros_like(value) if need_v else None
        gl = torch.zeros_like(loc) if need_l else None
        step = 1 if value.is_cuda else value.shape[0]
        for n in range(0, value.shape[0], step):
            v = value[n:n + step].detach().requires_grad_(need_v)
            lc = loc[n:n + step].detach().requires_grad_(need_l)
            with torch.enable_grad():
                out = msda_sample_plain(v, ctx.shapes, lc)
            wrt = [t for t in (v, lc) if t.requires_grad]
            if not wrt:
                break
            grads = iter(torch.autograd.grad(out, wrt, g[n:n + step]))
            if need_v:
                gv[n:n + step] = next(grads)
            if need_l:
                gl[n:n + step] = next(grads)
        return gv, gl, None


def msda_sample(value: torch.Tensor, spatial_shapes, loc: torch.Tensor) -> torch.Tensor:
    """[N, Lq, M*D]: plain law on the CPU, kernel A on CUDA;
    differentiable in ``value`` and ``loc``."""
    return _MsdaSample.apply(value, loc, spatial_shapes)


def _tent(i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """max(1 - |i - c|, 0) in float32."""
    return (1.0 - (i - c).abs()).clamp(min=0.0)


def msda_tent_base_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                         loc: torch.Tensor, dequant: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of kernel D: the bilinear sum with the rounding
    points of the TPU's base tent kernel (``_tent_kernel``).

    value [N, S, M, D] float32 / bfloat16, or its int8 slab with
    ``dequant`` [N, M, L] float32 (scale / 127 / 127) and ``dtype`` the
    slab's type; loc [N, Lq, M, L, P, 3] (x, y pixel coords, weight).
    Per sample, x tents ``tx = max(1 - |i - x|, 0) * w`` at the two
    columns around x; int8: ``mq = round(tx * 127)`` and
    ``t1 = sum_i mq * q`` (exact), else ``t1 = sum_i dtype(tx) * v``
    in float32; ``p2 = dtype(max(1 - |j - y|, 0) * t1)``; rows and points
    summed in float32, dequantized per level, levels summed from 0.
    -> [N, Lq, M*D] in ``dtype``."""
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    starts = _level_starts(spatial_shapes)
    assert starts[-1] == S and L == len(spatial_shapes)
    int8 = value.dtype == torch.int8
    assert int8 == (dequant is not None), "the int8 slab needs its dequant factors"
    dtype = dtype or value.dtype
    f32 = torch.float32
    out = torch.zeros((N, M, Lq, D), dtype=f32, device=value.device)
    xs = loc[..., 0].to(f32).permute(0, 2, 1, 3, 4)  # [N, M, Lq, L, P]
    ys = loc[..., 1].to(f32).permute(0, 2, 1, 3, 4)
    ws = loc[..., 2].to(f32).permute(0, 2, 1, 3, 4)
    for lid, (h, w) in enumerate(spatial_shapes):
        vl = value[:, starts[lid]:starts[lid + 1]].permute(0, 2, 1, 3)  # [N, M, hw, D]
        x, y, wa = xs[:, :, :, lid], ys[:, :, :, lid], ws[:, :, :, lid]  # [N, M, Lq, P]
        x0, y0 = torch.floor(x), torch.floor(y)
        taps = []
        for dx in (0, 1):
            i = x0 + dx
            tx = _tent(i, x) * wa
            tx = torch.round(tx * 127.0) if int8 else tx.to(dtype).to(f32)
            taps.append((i, torch.where((i >= 0) & (i <= w - 1), tx, 0.0)))
        row = torch.zeros((N, M, Lq, P, D), dtype=f32, device=value.device)
        for dy in (0, 1):
            j = y0 + dy
            t1 = None
            for i, tx in taps:
                idx = (j.clamp(0, h - 1) * w + i.clamp(0, w - 1)).to(torch.int64)
                g = torch.gather(vl, 2, idx.reshape(N, M, Lq * P, 1).expand(N, M, Lq * P, D))
                term = tx[..., None] * g.reshape(N, M, Lq, P, D).to(f32)
                t1 = term if t1 is None else t1 + term
            p2 = (_tent(j, y)[..., None] * t1).to(dtype).to(f32)
            row = row + torch.where(((j >= 0) & (j <= h - 1))[..., None], p2, 0.0)
        acc = torch.zeros((N, M, Lq, D), dtype=f32, device=value.device)
        for p in range(P):  # the kernel's order
            acc = acc + row[:, :, :, p]
        if int8:
            acc = acc * dequant[:, :, lid, None, None].to(f32)
        out = out + acc
    return out.permute(0, 2, 1, 3).reshape(N, Lq, M * D).to(dtype)


def msda_tent_base_cuda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                        loc: torch.Tensor, dequant: Optional[torch.Tensor] = None,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kernel D on the card: the arguments of ``msda_tent_base_plain``,
    all contiguous, loc and dequant float32 -> [N, Lq, M*D] in ``dtype``.

    A lane reads a piece of a head's channels (16 bytes of the int8 slab,
    32 of a value, or the whole head when it is narrower) with loads of up
    to 16 bytes, so D is a divisor or a multiple of 32 and the value is
    aligned to min(16, D * size) bytes; any other D raises."""
    N, S, M, D = value.shape
    if loc.dim() != 6 or loc.shape[0] != N or loc.shape[2] != M or loc.shape[-1] != 3:
        raise ValueError(f"msda_tent_base: loc {tuple(loc.shape)} does not match value "
                         f"{tuple(value.shape)}")
    L, P, Lq = loc.shape[3], loc.shape[4], loc.shape[1]
    if L != len(spatial_shapes) or _level_starts(spatial_shapes)[-1] != S:
        raise ValueError("msda_tent_base: spatial shapes do not match value / loc")
    if loc.dtype != torch.float32:
        raise TypeError("msda_tent_base: loc must be float32")
    int8 = value.dtype == torch.int8
    if int8 != (dequant is not None):
        raise ValueError("msda_tent_base: an int8 value needs dequant [N, M, L], any other none")
    if int8 and (tuple(dequant.shape) != (N, M, L) or dequant.dtype != torch.float32):
        raise ValueError(f"msda_tent_base: dequant must be float32 [{N}, {M}, {L}]")
    if not kernels.tent_head_ok(D):
        raise ValueError(f"msda_tent_base: head size D={D} is neither a divisor nor a "
                         "multiple of 32")
    dtype = dtype or value.dtype
    kernels.require_cuda("msda_tent_base", value, loc, dequant)
    align = kernels.load_align(D, value)
    if value.data_ptr() % align:
        raise ValueError(f"msda_tent_base: the value must be {align}-byte aligned")
    out = torch.empty((N, Lq, M * D), dtype=dtype, device=value.device)
    code = kernels.dtype_code(out)
    fn = kernels.lib("msda_tent_base").msda_tent_base_launch
    err = fn(code, int(int8), value.data_ptr(), dequant.data_ptr() if int8 else None,
             loc.data_ptr(), out.data_ptr(), N, S, Lq, M, D, P, L,
             kernels.shapes_arg(spatial_shapes), kernels.stream_arg(value.device))
    kernels.check("msda_tent_base", err)
    kernels.LAUNCHES["msda_tent_base"] += 1
    return out


def msda_tent_base(value: torch.Tensor, spatial_shapes, loc: torch.Tensor,
                   dequant: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[N, Lq, M*D]: plain version on the CPU, kernel D on CUDA."""
    if value.is_cuda:
        return msda_tent_base_cuda(value, spatial_shapes, loc, dequant, dtype)
    return msda_tent_base_plain(value, spatial_shapes, loc, dequant, dtype)


# 1 / 127 (value quantisation) * 1 / 127 (x-tent quantisation), in float32
_DEQUANT = 1.0 / (127.0 * 127.0)


def quantize_int8_slab(value: torch.Tensor, spatial_shapes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's int8 slab (``_msda_tent_level``,
    deformable_attention.py:372-379): per (frame, head, level),
    ``scale = max(max |v|, 1e-6)`` and ``q = round(v / scale * 127)``
    (half to even), in float32 -> (q [N, S, M, D] int8, scale [N, M, L])."""
    starts = _level_starts(spatial_shapes)
    qs, scales = [], []
    for lid in range(len(spatial_shapes)):
        v = value[:, starts[lid]:starts[lid + 1]].to(torch.float32)  # [N, hw, M, D]
        scale = v.abs().amax(dim=(1, 3)).clamp(min=1e-6)  # [N, M]
        qs.append(torch.round(v / scale[:, None, :, None] * 127.0).to(torch.int8))
        scales.append(scale)
    return torch.cat(qs, dim=1).contiguous(), torch.stack(scales, dim=-1).contiguous()


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


LEVEL_IMPLS = ("auto", "2d", "win", "base")


def ms_deform_attn_tent(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor, int8_slab: bool = False,
                        level_impl: str = "auto") -> torch.Tensor:
    """The JAX package's ``ms_deform_attn_tent`` contract and variant law
    (deformable_attention.py:748-753): a forced ``level_impl`` wins, even
    over ``int8_slab`` (``'2d'`` with ``int8_slab`` samples the value as
    it is); ``'auto'`` takes the base tent when ``int8_slab`` is set, else
    the 2-D tent (H*W <= 1024) or the windowed tent per level.  The 2-D
    and windowed tents compute one contract, kernel A's; the base tent is
    kernel D, over the int8 slab when ``int8_slab``.  The law picks one of
    the two for every level of a call alike."""
    if level_impl not in LEVEL_IMPLS:
        raise ValueError(f"level_impl must be one of {LEVEL_IMPLS}, got {level_impl!r}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    value = value.contiguous()
    loc = locations_to_rows(shapes, sampling_locations, attention_weights)
    if not (level_impl == "base" or (level_impl == "auto" and int8_slab)):
        return msda_sample(value, shapes, loc)
    if int8_slab:
        q, scale = quantize_int8_slab(value, shapes)
        dequant = scale * torch.tensor(_DEQUANT, dtype=torch.float32, device=scale.device)
        return msda_tent_base(q, shapes, loc, dequant, value.dtype)
    return msda_tent_base(value, shapes, loc)


IMPLS = ("auto", "tent", "tent-int8", "gather")


def ms_deform_attn(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The JAX package's ``ms_deform_attn`` contract: value [N, S, M, D],
    sampling_locations [N, Lq, M, L, P, 2] in [0, 1], attention_weights
    [N, Lq, M, L, P] (softmaxed) -> [N, Lq, M*D].

    impl: ``'auto'`` and ``'tent'`` take kernel A (the counterpart of
    the TPU's tent kernels), ``'tent-int8'`` kernel D over the int8 slab,
    ``'gather'`` the plain law (as JAX takes its XLA gather).  On the CPU
    every value takes the plain version of the kernel it names."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "gather":
        loc = locations_to_rows(spatial_shapes, sampling_locations, attention_weights)
        return msda_sample_plain(value, spatial_shapes, loc)
    return ms_deform_attn_tent(value, spatial_shapes, sampling_locations, attention_weights,
                               int8_slab=impl == "tent-int8")
