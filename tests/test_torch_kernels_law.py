"""The port's plain laws of its three CUDA kernels against the JAX
package's Pallas kernels (interpret mode, as tests/test_msda_rows.py and
tests/test_fused_mlp.py run them) on the CPU, in float32:

- rows (kernel B): ``msda_rows_plain`` against ``fused_sampling_rows``,
  through the re-layout to the TPU's point-minor packed rows, also at a
  query count that is not a multiple of the query block;
- sampler (kernel A): ``msda_sample_plain`` against
  ``ms_deform_attn_tent_rows`` and against ``_msda_gather``, with levels
  on both sides of the 2-D tent's 1024-pixel split, on random samples and
  on samples on and past every border of every level;
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


# level sizes whose query count (15 + 63 = 78) is not a multiple of the
# 32-query block: the ragged last block of every frame
RAGGED_SHAPES = ((3, 5), (7, 9))


@pytest.mark.parametrize("shapes", [((4, 6), (8, 12)), RAGGED_SHAPES], ids=["even", "ragged"])
def test_rows_law_matches_fused_sampling_rows(shapes):
    rng = np.random.RandomState(0)
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


def _border_inputs(seed, shapes, M, P, D, N=2):
    """``_sampler_inputs``' shapes (so the JAX side compiles once for
    both) with samples on and past every border of every level: pixel
    coordinates x, y each one of {-1.5, -1, -0.5, 0, size - 1, size - 0.5,
    size, size + 0.5} (the 64 pairs drawn per sample; as normalized
    locations (pixel + 0.5) / size), a quarter of the weights exactly 0."""
    rng = np.random.RandomState(seed)
    Lq, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(N, Lq, M, D).astype(np.float32)
    locs = np.empty((N, Lq, M, L, P, 2), np.float32)
    for lid, (h, w) in enumerate(shapes):
        k = rng.randint(0, 64, (N, Lq, M, P))
        for axis, size, sel in ((0, w, k % 8), (1, h, k // 8)):
            pix = np.array([-1.5, -1.0, -0.5, 0.0, size - 1.0, size - 0.5, size, size + 0.5])
            locs[:, :, :, lid, :, axis] = (pix[sel] + 0.5) / size
    attn = rng.rand(N, Lq, M, L, P).astype(np.float32)
    attn[rng.rand(N, Lq, M, L, P) < 0.25] = 0.0
    return value, locs, attn


SAMPLERS = {"random": _sampler_inputs, "border": _border_inputs}


@pytest.mark.parametrize("where", ["random", "border"])
def test_sample_law_matches_tent_rows_kernels(where):
    """Both TPU tent kernels: the 2-D tent (levels <= 1024 px) and the
    windowed tent (the 36x32 level, 1152 px)."""
    shapes = ((4, 6), (8, 12), (36, 32))
    M, P, D = 4, 4, 16
    value, locs, attn = SAMPLERS[where](1, shapes, M, P, D)
    Lq = locs.shape[1]
    rows = pack_tent_rows(shapes, jnp.asarray(locs), jnp.asarray(attn))
    want = ms_deform_attn_tent_rows(jnp.asarray(value), shapes, rows, Lq, P, interpret=True)
    loc = locations_to_rows(shapes, torch.as_tensor(locs), torch.as_tensor(attn))
    got = msda_sample_plain(torch.as_tensor(value), shapes, loc)
    _close(got.numpy(), want)


@pytest.mark.parametrize("D, where", [
    pytest.param(32, "random", id="32"), pytest.param(8, "random", id="8"),
    pytest.param(32, "border", id="32-border"), pytest.param(8, "border", id="8-border"),
])
def test_sample_law_matches_gather(D, where):
    """Against the XLA gather law, at the full-width head size (D=32) and
    at the tiny config's (D=8)."""
    shapes = ((2, 3), (8, 12), (40, 30))
    M, P = 2, 4
    value, locs, attn = SAMPLERS[where](2, shapes, M, P, D)
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


@pytest.mark.parametrize("dtype, D, refused", [
    (torch.bfloat16, 8, False), (torch.float32, 32, False),  # 16 and 128 bytes: 1 and 8 lanes
    (torch.bfloat16, 4, True), (torch.float32, 12, True), (torch.bfloat16, 128, True),
])
def test_sample_kernel_head_sizes(dtype, D, refused):
    """Kernel A's wrapper refuses a head whose channels are not 1, 2, 4 or
    8 whole 16-byte pieces before it reaches the card; a head it takes
    goes on to the device check (CPU tensors here)."""
    from univs_tpu_torch.ops.deformable_attention import msda_sample_cuda

    shapes = ((2, 3),)
    value = torch.zeros((1, 6, 2, D), dtype=dtype)
    loc = torch.zeros((1, 6, 2, 1, 2, 3))
    with pytest.raises(ValueError, match="head size" if refused else "CUDA device"):
        msda_sample_cuda(value, shapes, loc)
