"""The port's plain laws of its three CUDA kernels against the JAX
package's Pallas kernels (interpret mode, as tests/test_msda_rows.py and
tests/test_fused_mlp.py run them) on the CPU, in float32:

- rows (kernel B): ``msda_rows_plain`` against ``fused_sampling_rows``,
  through the re-layout to the TPU's point-minor packed rows;
- sampler (kernel A): ``msda_sample_plain`` against
  ``ms_deform_attn_tent_rows`` and against ``_msda_gather``, with levels
  on both sides of the 2-D tent's 1024-pixel split;
- fused FFN (kernel C): ``fused_ffn_ln_plain`` against ``fused_ffn_ln``.

Tolerance 1e-5, relative to each output's largest magnitude: float32
results of the same arithmetic in another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.ops.deformable_attention import (
    _msda_gather,
    ms_deform_attn_tent_rows,
    pack_tent_rows,
    tent_row_pad,
)
from univs_tpu.ops.fused_mlp import fused_ffn_ln
from univs_tpu.ops.msda_rows import fused_sampling_rows
from univs_tpu_torch.ops.deformable_attention import locations_to_rows, ms_deform_attn, msda_sample_plain
from univs_tpu_torch.ops.fused_mlp import fused_ffn_ln_plain
from univs_tpu_torch.ops.msda_rows import msda_rows_plain

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _packed_rows(loc):
    """loc [N, Lq, M, L, P, 3] -> the TPU kernel's [N, Lq*P, L*3*M] row
    layout (row = q*P + p; per level the lane block [x(M), y(M), w(M)])."""
    N, Lq, M, L, P, _ = loc.shape
    return loc.permute(0, 1, 4, 3, 5, 2).reshape(N, Lq * P, L * 3 * M)


def test_rows_law_matches_fused_sampling_rows():
    rng = np.random.RandomState(0)
    shapes = ((4, 6), (8, 12))
    M, P, C, N = 4, 4, 32, 2
    L = len(shapes)
    Lq = sum(h * w for h, w in shapes)
    q = rng.randn(N, Lq, C).astype(np.float32)
    wo = (rng.randn(C, M * L * P * 2) * 0.1).astype(np.float32)
    bo = rng.randn(M * L * P * 2).astype(np.float32)
    wa = (rng.randn(C, M * L * P) * 0.1).astype(np.float32)
    ba = (rng.randn(M * L * P) * 0.1).astype(np.float32)

    want = fused_sampling_rows(*[jnp.asarray(a) for a in (q, wo, bo, wa, ba)], shapes, M, P,
                               block_queries=32, pad_rows_to=tent_row_pad(), interpret=True)
    loc = msda_rows_plain(*[torch.as_tensor(a) for a in (q, wo, bo, wa, ba)], shapes, M, P)
    assert tuple(loc.shape) == (N, Lq, M, L, P, 3)
    got = _packed_rows(loc).numpy()
    R = Lq * P
    # the x / y lanes (pixel coordinates) and the weight lanes separately:
    # each is held to its own magnitude
    lane = np.arange(L * 3 * M) % (3 * M)
    for sel in (lane < 2 * M, lane >= 2 * M):
        _close(got[..., sel], np.asarray(want)[:, :R][..., sel])


def _sampler_inputs(seed, shapes, M, P, D, N=2):
    rng = np.random.RandomState(seed)
    Lq = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.randn(N, Lq, M, D).astype(np.float32)
    # locations in [-0.1, 1.1]: some corners fall outside (zero padding)
    locs = (rng.rand(N, Lq, M, L, P, 2) * 1.2 - 0.1).astype(np.float32)
    logits = rng.randn(N, Lq, M, L * P).astype(np.float32)
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(N, Lq, M, L, P).astype(np.float32)
    return value, locs, attn


def test_sample_law_matches_tent_rows_kernels():
    """Both TPU tent kernels: the 2-D tent (levels <= 1024 px) and the
    windowed tent (the 36x32 level, 1152 px)."""
    shapes = ((4, 6), (8, 12), (36, 32))
    M, P, D = 4, 4, 16
    value, locs, attn = _sampler_inputs(1, shapes, M, P, D)
    Lq = value.shape[1]
    rows = pack_tent_rows(shapes, jnp.asarray(locs), jnp.asarray(attn))
    want = ms_deform_attn_tent_rows(jnp.asarray(value), shapes, rows, Lq, P, interpret=True)
    loc = locations_to_rows(shapes, torch.as_tensor(locs), torch.as_tensor(attn))
    got = msda_sample_plain(torch.as_tensor(value), shapes, loc)
    _close(got.numpy(), want)


@pytest.mark.parametrize("D", [32, 8])
def test_sample_law_matches_gather(D):
    """Against the XLA gather law, at the full-width head size (D=32) and
    at the tiny config's (D=8)."""
    shapes = ((2, 3), (8, 12), (40, 30))
    M, P = 2, 4
    value, locs, attn = _sampler_inputs(2, shapes, M, P, D)
    want = _msda_gather(jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(attn))
    got = ms_deform_attn(torch.as_tensor(value), shapes, torch.as_tensor(locs),
                         torch.as_tensor(attn))
    _close(got.numpy(), want)


@pytest.mark.parametrize("tokens", [96, 1024 + 17])
def test_ffn_law_matches_fused_ffn_ln(tokens):
    rng = np.random.RandomState(0)
    C, F = 64, 128
    src = rng.randn(1, tokens, C).astype(np.float32)
    attn = rng.randn(1, tokens, C).astype(np.float32)
    g1, g2 = (rng.rand(C) + 0.5).astype(np.float32), (rng.rand(C) + 0.5).astype(np.float32)
    c1, c2 = (rng.randn(C) * 0.1).astype(np.float32), (rng.randn(C) * 0.1).astype(np.float32)
    w1, b1 = (rng.randn(C, F) * 0.05).astype(np.float32), (rng.randn(F) * 0.1).astype(np.float32)
    w2, b2 = (rng.randn(F, C) * 0.05).astype(np.float32), (rng.randn(C) * 0.1).astype(np.float32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    want = fused_ffn_ln(j(src), j(attn), {"scale": j(g1), "bias": j(c1)},
                        {"kernel": j(w1), "bias": j(b1)}, {"kernel": j(w2), "bias": j(b2)},
                        {"scale": j(g2), "bias": j(c2)}, block_tokens=128, interpret=True)
    t = torch.as_tensor
    got = fused_ffn_ln_plain(t(src), t(attn), t(g1), t(c1), t(w1), t(b1), t(w2), t(b2),
                             t(g2), t(c2))
    _close(got.numpy(), want)
