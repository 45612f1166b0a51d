"""The port's MSDA tent entry points against the JAX package's on the CPU:
the base tent (kernel D's plain version, ``msda_tent_base_plain``) with
the int8 slab and with float32 / bfloat16 values, against
``ms_deform_attn_tent`` with the Pallas ``_tent_kernel`` in interpret
mode (as tests/test_ops.py:108-160 runs it), and every ``impl`` of
``ms_deform_attn`` against the JAX package's same ``impl``.

Tolerances, relative to the reference's largest magnitude: 1e-5 for a
float32 output (the same roundings, another summation order), 1e-2 for a
bfloat16 output (one rounding of the output, ~2 ulp).  The int8 slabs
and their scales must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.ops.deformable_attention import ms_deform_attn as jax_msda
from univs_tpu.ops.deformable_attention import ms_deform_attn_tent as jax_tent
from univs_tpu_torch.ops import deformable_attention as da
from univs_tpu_torch.ops import kernels

torch.set_num_threads(1)

# a level above the 2-D tent's 1024-pixel split and two below it
SHAPES = ((6, 8), (3, 4), (36, 32))
N, M, D, Lq, P = 2, 4, 8, 9, 3


def _inputs(seed, shapes=SHAPES, d=D):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.randn(N, S, M, d).astype(np.float32)
    # out-of-range locations exercise the zero padding
    loc = rng.uniform(-0.2, 1.2, size=(N, Lq, M, L, P, 2)).astype(np.float32)
    w = rng.rand(N, Lq, M, L, P).astype(np.float32)
    w /= w.reshape(N, Lq, M, -1).sum(-1)[..., None, None]
    return value, loc, w


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _both(value, dtype):
    """The same value in both packages' arrays, in ``dtype``."""
    if dtype == "float32":
        return jnp.asarray(value), torch.as_tensor(value)
    return jnp.asarray(value, jnp.bfloat16), torch.as_tensor(value).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_slab_identical(dtype):
    """The int8 slab and its scales, per (frame, head, level), against
    the JAX package's (deformable_attention.py:372-379, over the d-major
    slab [N, M, W, D*H] of each level)."""
    value, _, _ = _inputs(0)
    jv, tv = _both(value, dtype)
    q, scale = da.quantize_int8_slab(tv, SHAPES)
    assert q.dtype == torch.int8 and tuple(scale.shape) == (N, M, len(SHAPES))
    start = 0
    for lid, (h, w) in enumerate(SHAPES):
        vl = jv[:, start:start + h * w]
        slab = jnp.moveaxis(vl, 2, 1).reshape(N, M, h, w, D)
        slab = slab.transpose(0, 1, 3, 4, 2).reshape(N, M, w, D * h)
        jscale = jnp.maximum(jnp.abs(slab.astype(jnp.float32)).max(axis=(2, 3)), 1e-6)
        jq = jnp.round(slab.astype(jnp.float32) / jscale[:, :, None, None] * 127.0).astype(jnp.int8)
        # the port's [N, hw, M, D] raster layout -> the d-major slab
        tq = q[:, start:start + h * w].numpy().reshape(N, h, w, M, D)
        tq = tq.transpose(0, 3, 2, 4, 1).reshape(N, M, w, D * h)
        np.testing.assert_array_equal(tq, np.asarray(jq))
        np.testing.assert_array_equal(scale[:, :, lid].numpy(), np.asarray(jscale))
        start += h * w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "base"])
def test_tent_base_matches_tent_kernel(mode, dtype):
    """``ms_deform_attn_tent(int8_slab=True)`` and ``level_impl='base'``
    against the Pallas ``_tent_kernel`` run in interpret mode."""
    value, loc, w = _inputs(1)
    jv, tv = _both(value, dtype)
    kw = dict(int8_slab=True) if mode == "int8" else dict(level_impl="base")
    want = jax_tent(jv, SHAPES, jnp.asarray(loc), jnp.asarray(w), interpret=True, **kw)
    got = da.ms_deform_attn_tent(tv, SHAPES, torch.as_tensor(loc), torch.as_tensor(w), **kw)
    assert got.dtype == tv.dtype and str(want.dtype) == dtype
    _close(got.float().numpy(), np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 1e-2)


def test_tent_base_head_width_32():
    """The full-width head size (D=32), int8 slab, float32."""
    value, loc, w = _inputs(2, shapes=((5, 7), (10, 14)), d=32)
    shapes = ((5, 7), (10, 14))
    want = jax_tent(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w),
                    interpret=True, int8_slab=True)
    got = da.ms_deform_attn_tent(torch.as_tensor(value), shapes, torch.as_tensor(loc),
                                 torch.as_tensor(w), int8_slab=True)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("impl", ["auto", "tent", "tent-int8", "gather"])
def test_ms_deform_attn_impls_match_jax(impl):
    """Each ``impl`` against the JAX package's same ``impl``.  JAX's
    'tent' and 'tent-int8' are its Pallas kernels, run here in interpret
    mode through ``ms_deform_attn_tent``; its 'auto' on the CPU is the
    gather."""
    value, loc, w = _inputs(3)
    args = (jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w))
    if impl in ("tent", "tent-int8"):
        want = jax_tent(*args, interpret=True, int8_slab=impl == "tent-int8")
    else:
        want = jax_msda(*args, impl=impl)
    got = da.ms_deform_attn(torch.as_tensor(value), SHAPES, torch.as_tensor(loc),
                            torch.as_tensor(w), impl=impl)
    _close(got.numpy(), want, 1e-5)


def test_forced_2d_wins_over_int8():
    """JAX's forced '2d' with ``int8_slab`` runs the float 2-D tent kernel
    on every level: the port takes kernel A's law, not the int8 slab."""
    value, loc, w = _inputs(4)
    want = jax_tent(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w),
                    interpret=True, int8_slab=True, level_impl="2d")
    got = da.ms_deform_attn_tent(torch.as_tensor(value), SHAPES, torch.as_tensor(loc),
                                 torch.as_tensor(w), int8_slab=True, level_impl="2d")
    _close(got.numpy(), want, 1e-5)


def test_int8_error_within_quantisation_bound():
    """The int8 trade against the float32 law: within ~|v|_max/127 per
    sample (tests/test_ops.py:108's bound), and above the float path's."""
    value, loc, w = _inputs(5)
    args = (torch.as_tensor(value), SHAPES, torch.as_tensor(loc), torch.as_tensor(w))
    exact = da.ms_deform_attn(*args, impl="gather")
    err8 = float((da.ms_deform_attn(*args, impl="tent-int8") - exact).abs().max())
    err = float((da.ms_deform_attn(*args, impl="tent") - exact).abs().max())
    scale = float(exact.abs().max())
    assert err <= 1e-6 * scale < err8 < 0.05 * scale


def test_cpu_takes_plain_versions_and_raises_on_bad_input(monkeypatch):
    """CPU tensors never reach a kernel; the card wrapper refuses CPU
    tensors and an int8 slab without its dequant factors."""
    def no_kernels(name):
        raise AssertionError(f"kernel {name} requested for CPU tensors")

    monkeypatch.setattr(kernels, "lib", no_kernels)
    kernels.reset_launch_counts()
    value, loc, w = _inputs(6)
    for impl in da.IMPLS:
        da.ms_deform_attn(torch.as_tensor(value), SHAPES, torch.as_tensor(loc),
                          torch.as_tensor(w), impl=impl)
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    rows = da.locations_to_rows(SHAPES, torch.as_tensor(loc), torch.as_tensor(w))
    q, scale = da.quantize_int8_slab(torch.as_tensor(value), SHAPES)
    with pytest.raises(ValueError, match="CUDA device"):
        da.msda_tent_base_cuda(q, SHAPES, rows, scale, torch.float32)
    with pytest.raises(ValueError, match="dequant"):
        da.msda_tent_base_cuda(q, SHAPES, rows)
    with pytest.raises(ValueError, match="impl"):
        da.ms_deform_attn(torch.as_tensor(value), SHAPES, torch.as_tensor(loc),
                          torch.as_tensor(w), impl="tent-int4")
