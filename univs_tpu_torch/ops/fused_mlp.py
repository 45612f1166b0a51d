"""Fused residual + LayerNorm + FFN + LayerNorm of the deformable
encoder layers (counterpart of ``univs_tpu/ops/fused_mlp.py``):

    u   = LN1(src + attn_out)
    out = LN2(u + W2 relu(W1 u + b1) + b2)

LayerNorm statistics in float32; the products see u and the hidden
activation in the layer dtype and accumulate in float32 (the TPU
kernel's law, ``fused_mlp.py:27-43``).  Weights are in the JAX layout
``[in, out]``.  ``fused_ffn_ln`` dispatches on the device: the CPU takes
``fused_ffn_ln_plain``, a CUDA tensor launches kernel C
(``csrc/fused_ffn_ln.cu``) or raises.  The JAX package's kernel has no
gradient (its training takes the unfused law); here ``fused_ffn_ln`` is
differentiable: the forward is the kernel, the backward recomputes the
unfused law ``fused_ffn_ln_plain`` (float32 LayerNorms, the products in
the layer dtype) under autograd, each gradient in its input's dtype.  ``ffn_body`` is the one place that
chooses kernel C's body; the launch refuses a body that does not fit.
"""

from __future__ import annotations

import torch

from univs_tpu_torch.ops import kernels


def _ln(z: torch.Tensor, g: torch.Tensor, c: torch.Tensor, eps: float) -> torch.Tensor:
    mu = z.mean(-1, keepdim=True)
    zc = z - mu
    var = (zc * zc).mean(-1, keepdim=True)
    return zc * torch.rsqrt(var + eps) * g.to(torch.float32) + c.to(torch.float32)


# kernel C's bodies (the code the launch takes) and the widths its wgmma
# body is built for: C = 256, F a multiple of the 64-column hidden chunk
BODIES = {"fma": 0, "wgmma": 1}
WGMMA_C = 256
WGMMA_CHUNK = 64


def ffn_body(dtype: torch.dtype, C: int, F: int) -> str:
    """The body kernel C runs for these widths: ``"wgmma"`` (bf16, C =
    256, F a multiple of 64: every launch of the model paths), else
    ``"fma"``."""
    if dtype == torch.bfloat16 and C == WGMMA_C and F > 0 and F % WGMMA_CHUNK == 0:
        return "wgmma"
    return "fma"


def fused_ffn_ln_plain(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps: float = 1e-5):
    """Plain PyTorch version of kernel C: src/attn_out [N, S, C],
    w1 [C, F], w2 [F, C] -> [N, S, C] in src's dtype."""
    dt = src.dtype
    f32 = torch.float32
    u = _ln(src.to(f32) + attn_out.to(f32), g1, c1, eps)
    y1 = torch.relu(u.to(dt).to(f32) @ w1.to(f32) + b1.to(f32))
    y2 = y1.to(dt).to(f32) @ w2.to(f32)
    return _ln(u + y2 + b2.to(f32), g2, c2, eps).to(dt)


def fused_ffn_ln_cuda(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps: float = 1e-5):
    """Kernel C on the card, in the body ``ffn_body`` names.  src,
    attn_out, w1, w2 share one dtype (float32 or bfloat16) and src /
    attn_out are contiguous.  The kernel reads the weights in nn.Linear's
    ``[out, in]`` layout, so ``w1.t()`` / ``w2.t()`` are made contiguous
    here (free when the caller passes ``linear.weight.t()``, which also
    keeps the wgmma body's weight tensor maps, cached per weight address,
    from being encoded again); the vectors are cast to float32 here."""
    N, S, C = src.shape
    F = w1.shape[1]
    if tuple(attn_out.shape) != (N, S, C) or tuple(w1.shape) != (C, F) or tuple(w2.shape) != (F, C):
        raise ValueError(f"fused_ffn_ln: shapes src {tuple(src.shape)}, attn "
                         f"{tuple(attn_out.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if not (attn_out.dtype == w1.dtype == w2.dtype == src.dtype):
        raise TypeError("fused_ffn_ln: src, attn_out, w1 and w2 must share one dtype")
    vec = [v.to(torch.float32).contiguous() for v in (g1, c1, b1, b2, g2, c2)]
    if any(v.numel() != n for v, n in zip(vec, (C, C, F, C, C, C))):
        raise ValueError("fused_ffn_ln: LayerNorm / bias vectors of the wrong length")
    w1_k, w2_k = w1.t().contiguous(), w2.t().contiguous()  # [F, C], [C, F]
    kernels.require_cuda("fused_ffn_ln", src, attn_out, w1_k, w2_k, *vec)
    code = kernels.dtype_code(src)
    body = ffn_body(src.dtype, C, F)
    out = torch.empty_like(src)
    if body == "wgmma" and any(t.data_ptr() % 16 for t in (src, attn_out, w1_k, w2_k, out)):
        raise ValueError("fused_ffn_ln: the wgmma body needs 16-byte aligned tensors")
    g1_, c1_, b1_, b2_, g2_, c2_ = vec
    fn = kernels.lib("fused_ffn_ln").fused_ffn_ln_launch
    err = fn(BODIES[body], code, src.data_ptr(), attn_out.data_ptr(), g1_.data_ptr(),
             c1_.data_ptr(), w1_k.data_ptr(), b1_.data_ptr(), w2_k.data_ptr(), b2_.data_ptr(),
             g2_.data_ptr(), c2_.data_ptr(), out.data_ptr(), N * S, C, F, float(eps),
             kernels.stream_arg(src.device))
    kernels.check("fused_ffn_ln", err)
    kernels.LAUNCHES["fused_ffn_ln"] += 1
    return out


class _FusedFfnLn(torch.autograd.Function):
    """Kernel C forward (the plain law on the CPU); the backward is the
    vector-Jacobian product of ``fused_ffn_ln_plain``, recomputed."""

    @staticmethod
    def forward(ctx, src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps):
        ctx.save_for_backward(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2)
        ctx.eps = eps
        if src.is_cuda:
            return fused_ffn_ln_cuda(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps)
        return fused_ffn_ln_plain(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:10])]
        with torch.enable_grad():
            out = fused_ffn_ln_plain(*inputs, ctx.eps)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


def fused_ffn_ln(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps: float = 1e-5):
    """Plain law on the CPU, kernel C on CUDA; differentiable in every
    tensor input."""
    return _FusedFfnLn.apply(src, attn_out, g1, c1, w1, b1, w2, b2, g2, c2, eps)
