"""Gradients of kernels A, B and C (``msda_sample``, ``msda_rows``,
``fused_ffn_ln``): on the CPU each wrapper's backward is the
vector-Jacobian product of its plain law; held in float32 within 1e-5
(of each gradient's scale) to ``jax.vjp`` of the JAX package's
differentiable laws: ``_msda_gather`` (the tent op's VJP), B then A
against ``_xla_sampling_law`` (the fused sampling's VJP), and C against
the unfused residual + LayerNorm + FFN + LayerNorm of the JAX encoder
layer.  The gradients come back in each input's dtype."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.ops.deformable_attention import _msda_gather
from univs_tpu.ops.msda_rows import _xla_sampling_law
from univs_tpu_torch.ops.deformable_attention import msda_sample
from univs_tpu_torch.ops.fused_mlp import fused_ffn_ln
from univs_tpu_torch.ops.msda_rows import msda_rows

torch.set_num_threads(1)

SHAPES = ((2, 3), (4, 6), (8, 12))
TOL = 1e-5


def _close(got: torch.Tensor, want, name):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= TOL * scale, (name, err, scale)


def _rows(loc, attn, shapes):
    """Normalized locations [N, Lq, M, L, P, 2] + weights -> kernel A's
    rows (x, y pixel coordinates, weight)."""
    W = torch.tensor([w for _, w in shapes], dtype=torch.float32)
    H = torch.tensor([h for h, _ in shapes], dtype=torch.float32)
    x = loc[..., 0] * W[:, None] - 0.5
    y = loc[..., 1] * H[:, None] - 0.5
    return torch.stack([x, y, attn], dim=-1)


@pytest.mark.parametrize("seed,M,D,P", [(0, 4, 8, 2), (1, 2, 16, 4)])
def test_kernel_a_gradient_matches_jax_gather(seed, M, D, P):
    rng = np.random.RandomState(seed)
    N, L = 2, len(SHAPES)
    S = sum(h * w for h, w in SHAPES)
    value = rng.randn(N, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (N, S, M, L, P, 2)).astype(np.float32)  # some out of bounds
    attn = rng.rand(N, S, M, L, P).astype(np.float32)
    g = rng.randn(N, S, M * D).astype(np.float32)

    _, vjp = jax.vjp(lambda v, l, a: _msda_gather(v, SHAPES, l, a), jnp.asarray(value),
                     jnp.asarray(loc), jnp.asarray(attn))
    dv, dl, da = vjp(jnp.asarray(g))

    tv, tl, ta = (torch.tensor(x, requires_grad=True) for x in (value, loc, attn))
    out = msda_sample(tv, SHAPES, _rows(tl, ta, SHAPES))
    out.backward(torch.as_tensor(g))
    _close(tv.grad, dv, "value")
    _close(tl.grad, dl, "loc")
    _close(ta.grad, da, "weights")


@pytest.mark.parametrize("seed,M,P", [(0, 4, 2), (1, 2, 4)])
def test_kernel_b_gradient_matches_jax_sampling_law(seed, M, P):
    rng = np.random.RandomState(seed)
    N, C, L = 2, 32, len(SHAPES)
    Lq = sum(h * w for h, w in SHAPES)
    Da = M * L * P
    arrs = dict(value=rng.randn(N, Lq, M, C // M), query=rng.randn(N, Lq, C),
                wo=rng.randn(C, 2 * Da) * 0.05, bo=rng.randn(2 * Da),
                wa=rng.randn(C, Da) * 0.2, ba=rng.randn(Da) * 0.2)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    g = rng.randn(N, Lq, C).astype(np.float32)
    names = ("value", "query", "wo", "bo", "wa", "ba")

    _, vjp = jax.vjp(lambda *a: _xla_sampling_law(*a, SHAPES, M, P),
                     *(jnp.asarray(arrs[k]) for k in names))
    want = vjp(jnp.asarray(g))

    t = {k: torch.tensor(arrs[k], requires_grad=True) for k in names}
    loc = msda_rows(t["query"], t["wo"], t["bo"], t["wa"], t["ba"], SHAPES, M, P)
    msda_sample(t["value"], SHAPES, loc).backward(torch.as_tensor(g))
    for k, w in zip(names, want):
        _close(t[k].grad, w, k)


def _jax_unfused_ffn(src, attn, g1, c1, w1, b1, w2, b2, g2, c2):
    ln = fnn.LayerNorm(epsilon=1e-5)
    u = ln.apply({"params": {"scale": g1, "bias": c1}}, src + attn)
    y = fnn.Dense(w1.shape[1]).apply({"params": {"kernel": w1, "bias": b1}}, u)
    y = fnn.Dense(w2.shape[1]).apply({"params": {"kernel": w2, "bias": b2}}, fnn.relu(y))
    return ln.apply({"params": {"scale": g2, "bias": c2}}, u + y)


@pytest.mark.parametrize("seed,C,F", [(0, 32, 64), (1, 16, 48)])
def test_kernel_c_gradient_matches_jax_unfused_law(seed, C, F):
    rng = np.random.RandomState(seed)
    N, S = 2, 21
    arrs = dict(src=rng.randn(N, S, C), attn=rng.randn(N, S, C), g1=1 + 0.1 * rng.randn(C),
                c1=0.1 * rng.randn(C), w1=rng.randn(C, F) / np.sqrt(C), b1=0.1 * rng.randn(F),
                w2=rng.randn(F, C) / np.sqrt(F), b2=0.1 * rng.randn(C), g2=1 + 0.1 * rng.randn(C),
                c2=0.1 * rng.randn(C))
    names = tuple(arrs)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    g = rng.randn(N, S, C).astype(np.float32)
    out_j, vjp = jax.vjp(_jax_unfused_ffn, *(jnp.asarray(arrs[k]) for k in names))
    want = vjp(jnp.asarray(g))

    t = {k: torch.tensor(arrs[k], requires_grad=True) for k in names}
    out = fused_ffn_ln(*(t[k] for k in names))
    _close(out, out_j, "forward")
    out.backward(torch.as_tensor(g))
    for k, w in zip(names, want):
        _close(t[k].grad, w, k)


def test_gradients_come_back_in_each_inputs_dtype():
    rng = np.random.RandomState(3)
    N, C, M, P, L = 1, 32, 4, 2, len(SHAPES)
    Lq = sum(h * w for h, w in SHAPES)
    Da = M * L * P
    bf = torch.bfloat16
    q = torch.tensor(rng.randn(N, Lq, C), dtype=bf, requires_grad=True)
    wo = torch.tensor(rng.randn(C, 2 * Da) * 0.05, dtype=bf, requires_grad=True)
    bo = torch.tensor(rng.randn(2 * Da), dtype=torch.float32, requires_grad=True)
    wa = torch.tensor(rng.randn(C, Da) * 0.2, dtype=bf, requires_grad=True)
    ba = torch.tensor(rng.randn(Da), dtype=bf, requires_grad=True)
    v = torch.tensor(rng.randn(N, Lq, M, C // M), dtype=bf, requires_grad=True)
    loc = msda_rows(q, wo, bo, wa, ba, SHAPES, M, P)
    assert loc.dtype == torch.float32
    out = msda_sample(v, SHAPES, loc)
    assert out.dtype == bf
    ffn = [torch.tensor(x, dtype=bf, requires_grad=True) for x in
           (1 + 0.1 * rng.randn(C), rng.randn(C) * 0.1, rng.randn(C, 64) / 8, rng.randn(64) * 0.1,
            rng.randn(64, C) / 8, rng.randn(C) * 0.1, 1 + 0.1 * rng.randn(C), rng.randn(C) * 0.1)]
    y = fused_ffn_ln(q, out, *ffn)
    y.float().square().sum().backward()
    for t in (q, wo, bo, wa, ba, v, *ffn):
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert bool(torch.isfinite(t.grad.float()).all())
    # the pixel decoder passes weights as views of nn.Linear's: the
    # gradient reaches the Linear's weight
    lin = torch.nn.Linear(C, 2 * Da)
    loc = msda_rows(q.detach().float(), lin.weight.t(), lin.bias, wa.detach().float(),
                    ba.detach().float(), SHAPES, M, P)
    loc.sum().backward()
    assert lin.weight.grad is not None and lin.weight.grad.shape == lin.weight.shape
