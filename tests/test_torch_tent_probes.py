"""The port's tent probes (``univs_tpu_torch.tools``, over the plain
versions of kernels E and F) against the JAX package's probes of
``tools/`` on the CPU, with ``pl.pallas_call`` run in interpret mode (the
probes look it up at call time).

Tolerances, relative to the reference's largest magnitude: 1e-5 where
every step is float32 (the same roundings, another summation order),
1e-2 where a law rounds to bfloat16 (one rounding of the plane or the
taps may land one ulp apart, ~2^-8 of one term); and in both, 99 % of
the elements within 1e-6, which holds the rounding points themselves.
The probes' inputs and window metadata must be identical."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tools import probe_tent_kernel as j_kernel
from tools import probe_tent_outer as j_outer
from tools import probe_tent_psum as j_psum
from tools import probe_tent_v5 as j_v5
from tools import probe_tent_variants as j_variants
from univs_tpu_torch.ops import kernels, msda_probes
from univs_tpu_torch.tools import probe_tent_kernel as t_kernel
from univs_tpu_torch.tools import probe_tent_outer as t_outer
from univs_tpu_torch.tools import probe_tent_psum as t_psum
from univs_tpu_torch.tools import probe_tent_v5 as t_v5
from univs_tpu_torch.tools import probe_tent_variants as t_variants

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _both(a, dtype):
    """The same float32 numpy array in both packages, in ``dtype``."""
    a = np.asarray(a, np.float32)
    if dtype == "float32":
        return jnp.asarray(a), torch.as_tensor(a)
    return jnp.asarray(a, jnp.bfloat16), torch.as_tensor(a).to(torch.bfloat16)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)
    # the same rounding points: nearly every element agrees to float32
    # summation order, where one bf16 rounding dropped or added moves most
    # elements by ~2^-9 of their size
    agree = float(np.mean(np.abs(got - want) <= 1e-6 * scale))
    assert agree >= 0.99, agree


def _tol(dtype, rounds_bf16=False):
    return 1e-2 if dtype == "bfloat16" or rounds_bf16 else 1e-5


# --- kernel E: psum / outer ---------------------------------------------------

# one level of 16 x 12 (queries of both levels sample it), 2 heads, 2
# points, D=8; chunks of 32 queries against a window of 8 rows: the
# level's own queries mostly hit, the other level's miss
SHAPES = ((16, 12), (8, 6))
M, P, N, D = 2, 2, 1, 8
BQQ, SUBQ, HW = 32, 32, 8


def test_probe_inputs_identical():
    loc, wa, hh, ww = j_psum.production_loc(SHAPES, 0, M, P, N)
    tloc, twa, thh, tww = t_psum.production_loc(SHAPES, 0, M, P, N)
    np.testing.assert_array_equal(loc, tloc)
    np.testing.assert_array_equal(wa, twa)
    assert (hh, ww) == (thh, tww)
    ported = t_psum.rows_pointminor(loc, wa, hh, ww)
    for j, t in zip(j_psum.rows_pointminor(loc, wa, hh, ww), ported):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(j_psum.rows_qmajor(loc, wa, hh, ww, BQQ)),
                                  t_psum.rows_qmajor(loc, wa, hh, ww, BQQ).numpy())
    assert t_outer.production_loc is t_psum.production_loc


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["psum", "outer"])
def test_plane_matches_jax(interpret, mode, dtype, window):
    """``msda_psum2d`` / ``msda_outer2d`` and their windowed forms against
    the Pallas kernels; the window meta identical, with chunks that hit
    and chunks that miss."""
    loc, wa, hh, ww = j_psum.production_loc(SHAPES, 0, M, P, N)
    rows = t_psum.rows_qmajor(loc, wa, hh, ww, BQQ)
    RQ = loc.shape[1]
    slab = np.random.RandomState(1).randn(N, M, hh * ww, D)
    js, ts = _both(slab, dtype)
    jrows = jnp.asarray(rows.numpy())
    jmod, tmod = (j_psum, t_psum) if mode == "psum" else (j_outer, t_outer)
    name = "msda_psum2d" if mode == "psum" else "msda_outer2d"
    kw = dict(bqq=BQQ, subq=SUBQ)
    if window:
        want, jmeta = getattr(jmod, name + "_win")(js, jrows, RQ, D, P, ww, HW, **kw)
        got, meta = getattr(tmod, name + "_win")(ts, rows, RQ, D, P, ww, HW, **kw)
        np.testing.assert_array_equal(meta.numpy(), np.asarray(jmeta))
        hit = float(meta[..., 1].float().mean())
        assert 0 < hit < 1, hit
    else:
        want = getattr(jmod, name)(js, jrows, RQ, D, P, ww, **kw)
        got = getattr(tmod, name)(ts, rows, RQ, D, P, ww, **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, _tol(dtype))


# --- kernel F: the separable tent laws ---------------------------------------


def _samples(seed, R, H, W, clustered_head=False):
    """xs, ys, was [N, R, M]: coordinates a little past both edges (zero
    padding); with ``clustered_head`` head 1's y stays in rows 0..3."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-1.5, W + 0.5, (N, R, M))
    ys = rng.uniform(-1.5, H + 0.5, (N, R, M))
    if clustered_head:
        ys[:, :, 1] = rng.uniform(0.0, 3.0, (N, R))
    was = rng.rand(N, R, M)
    return [np.asarray(a, np.float32) for a in (xs, ys, was)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_tent_kernel_matches_jax(interpret, dtype):
    """``msda_tent`` (no weights, per sample) at the probe's D=32, the
    module global its JAX kernel reads."""
    H, W, R4 = 5, 7, 24
    slab = np.random.RandomState(2).randn(N, M, W, 32 * H)
    xs, ys, _ = _samples(3, R4, H, W)
    js, ts = _both(slab, dtype)
    want = j_kernel.msda_tent(js, jnp.asarray(xs), jnp.asarray(ys), bq=8)
    got = t_kernel.msda_tent(ts, torch.as_tensor(xs), torch.as_tensor(ys), bq=8)
    _close(got.numpy(), want, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", t_variants.VARIANTS)
def test_variants_match_jax(interpret, variant, dtype):
    """``run_level`` in every variant (padded to 1024 rows by the JAX
    one); bf16 rounding whatever the slab's dtype."""
    H, W, R = 6, 9, 40
    slab = np.random.RandomState(4).randn(N, M, W, D * H)
    xs, ys, was = _samples(5, R, H, W)
    js, ts = _both(slab, dtype)
    want = j_variants.run_level(js, *map(jnp.asarray, (xs, ys, was)), D, P, variant)
    got = t_variants.run_level(ts, *map(torch.as_tensor, (xs, ys, was)), D, P, variant)
    _close(got.numpy(), want, _tol(dtype, rounds_bf16=True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b16p2", [False, True])
def test_exp_matches_jax(interpret, b16p2, dtype):
    """``run_exp`` (padded to 8192 rows by the JAX one) over the j-major
    slab, with a window that misses for head 0 and hits for head 1."""
    H, W, R, Hw = 40, 5, 32, 16
    slab = np.random.RandomState(6).randn(N, M, W, H * D)
    xs, ys, was = _samples(7, R, H, W, clustered_head=True)
    js, ts = _both(slab, dtype)
    want = j_v5.run_exp(js, *map(jnp.asarray, (xs, ys, was)), D, P, Hw, b16p2)
    got = t_v5.run_exp(ts, *map(torch.as_tensor, (xs, ys, was)), D, P, Hw, b16p2)
    _close(got.numpy(), want, _tol(dtype))


# --- the runners on the CPU ---------------------------------------------------

TINY = dict(shapes=((8, 12), (4, 6), (2, 3)), M=2, P=2, N=1, D=8, bqq=64, subq=64)
RUNNERS = {
    "psum": lambda: t_psum.run("cpu", windows={0: (4,), 1: (2,)}, **TINY),
    "outer": lambda: t_outer.run("cpu", windows={0: (4,), 1: (2,)}, dtype=torch.float32, **TINY),
    "kernel": lambda: t_kernel.run("cpu", levels=[(2, 3), (4, 6), (8, 12)], n=1, m=2, d=8, p=2),
    "variants": lambda: t_variants.run("cpu", H=8, W=12, D=8, M=2, P=2, N=1, Lq=30),
    "v5": lambda: t_v5.run("cpu", H=16, W=6, D=8, M=2, P=2, N=1, Lq=30, Hw=4),
}


@pytest.mark.parametrize("probe", sorted(RUNNERS))
def test_runner_on_cpu(probe, monkeypatch):
    """Each ported probe's runner at a tiny geometry on the CPU: finite
    records within their tolerance of the float32 gather law, kernel A
    beside each level, no kernel requested, nothing timed."""
    def no_kernels(name):
        raise AssertionError(f"kernel {name} requested for CPU tensors")

    monkeypatch.setattr(kernels, "lib", no_kernels)
    kernels.reset_launch_counts()
    records = RUNNERS[probe]()
    assert records and all(r["pass"] and np.isfinite(r["err"]) for r in records), records
    assert all(r["ms"] is None and r["calls"] == 1 for r in records)
    assert {r["kernel"] for r in records} == {"msda_sample", "msda_tent_plane" if probe in (
        "psum", "outer") else "msda_tent_probe"}
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_arguments():
    slab = torch.zeros(1, 2, 12, 8)
    rows = torch.zeros(1, 64, 3 * 2 * 2)
    with pytest.raises(ValueError, match="CUDA device"):
        msda_probes.msda_tent_plane_cuda(slab, rows, 60, 4, 2, "psum")
    with pytest.raises(ValueError, match="mode"):
        msda_probes.msda_tent_plane(slab, rows, 60, 4, 2, "dense")
    xs = torch.zeros(1, 8, 2)
    slab_f = torch.zeros(1, 2, 4, 8 * 3)
    with pytest.raises(ValueError, match="CUDA device"):
        msda_probes.msda_tent_probe_cuda(slab_f, xs, xs, xs, 8, 2, "base", "dmajor")
    with pytest.raises(ValueError, match="law"):
        msda_probes.msda_tent_probe(slab_f, xs, xs, xs, 8, 2, "b8", "dmajor")
    with pytest.raises(ValueError, match="was"):
        msda_probes.msda_tent_probe(slab_f, xs, xs, None, 8, 2, "base", "dmajor")
    with pytest.raises(ValueError, match="window"):
        t_v5.run_exp(slab_f, xs, xs, xs, 8, 2, 4, False)
