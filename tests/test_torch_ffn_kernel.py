"""Kernel C (``csrc/fused_ffn_ln.cu``) around the card, on the CPU:

- ``kernels._stale``: a library older than its source or than any header
  under ``csrc/`` (one added later too) is rebuilt, a newer one is not;
- ``ffn_body``, the one place that chooses the body: the wgmma body for the
  model paths' bf16 launches (30- and 5-frame windows at full width), the
  FMA body for float32, the tiny config and widths the tile does not fit;
  the wrapper hands that body to the launch and raises when the launch
  refuses it (a stand-in library records the call; no card is needed);
- the wrapper's refusals before it reaches the card: shapes, mixed dtypes,
  vectors of the wrong length, tensors the wgmma body cannot read;
- the bf16 law: ``fused_ffn_ln_plain`` against the JAX package's
  ``fused_ffn_ln`` (interpret mode) in bf16 on inputs with a large common
  offset, the rounding points both bodies keep (u and the hidden
  activation rounded to bf16 before the products, float32 statistics and
  accumulation, the residual in float32).  Both sides round the hidden
  activation and the output to bf16 after float32 sums taken in another
  order, so an element may differ by one bf16 step: at least 98 % of the
  outputs are identical and none is further than 1e-2 of the largest.
  Moving any rounding point (u or the hidden activation unrounded, the
  residual rounded) or a one-pass variance on the offset inputs leaves
  only 60-72 % identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.ops.fused_mlp import fused_ffn_ln
from univs_tpu_torch.ops import fused_mlp, kernels

torch.set_num_threads(1)

FULL_TOKENS = 12600  # tokens a frame at 640x960: levels 20x30, 40x60, 80x120


# ---------------------------------------------------------------------------
# staleness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("touched, stale", [
    (None, False), ("fused_ffn_ln.cu", True), ("common.cuh", True), ("hopper.cuh", True),
    ("added_later.cuh", True), ("msda_rows.cu", False),
])
def test_stale_sees_the_source_and_every_header(tmp_path, monkeypatch, touched, stale):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    for f in ("fused_ffn_ln.cu", "msda_rows.cu", "common.cuh", "hopper.cuh"):
        (csrc / f).write_text("")
        os.utime(csrc / f, (1000, 1000))
    assert kernels._stale("fused_ffn_ln")  # no library yet
    lib = build / "libfused_ffn_ln.so"
    lib.write_text("")
    os.utime(lib, (2000, 2000))
    if touched is not None:
        (csrc / touched).write_text("// changed")
        os.utime(csrc / touched, (3000, 3000))
    assert kernels._stale("fused_ffn_ln") is stale


# ---------------------------------------------------------------------------
# body choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens, dtype, C, F, body", [
    pytest.param(30 * FULL_TOKENS, torch.bfloat16, 256, 1024, "wgmma", id="vis-30-frames"),
    pytest.param(5 * FULL_TOKENS, torch.bfloat16, 256, 1024, "wgmma", id="vss-5-frames"),
    pytest.param(37, torch.bfloat16, 256, 1024, "wgmma", id="below-one-tile"),
    pytest.param(2 * FULL_TOKENS, torch.float32, 256, 1024, "fma", id="float32"),
    pytest.param(2 * 126, torch.float32, 32, 64, "fma", id="tiny-float32"),
    pytest.param(2 * 126, torch.bfloat16, 32, 64, "fma", id="tiny-bf16"),
    pytest.param(FULL_TOKENS, torch.bfloat16, 256, 1000, "fma", id="hidden-not-chunked"),
    pytest.param(FULL_TOKENS, torch.bfloat16, 128, 1024, "fma", id="other-width"),
])
def test_body_choice(tokens, dtype, C, F, body):
    """The body depends on the widths and the dtype only: one tile walk
    serves any token count."""
    assert fused_mlp.ffn_body(dtype, C, F) == body


def _ffn_args(N, S, C, F, dtype, seed=0, offset=0.0):
    """src, attn [N, S, C] in ``dtype`` (their sum: mean ``offset``, std
    ~1), then the vectors and the weights as the model passes them
    (``linear.weight.t()`` views), seeded with numpy."""
    rng = np.random.RandomState(seed)
    src = (offset + 0.6 * rng.randn(N, S, C)).astype(np.float32)
    attn = (0.8 * rng.randn(N, S, C)).astype(np.float32)
    g1, g2 = (rng.rand(C) + 0.5).astype(np.float32), (rng.rand(C) + 0.5).astype(np.float32)
    c1, c2 = (rng.randn(C) * 0.1).astype(np.float32), (rng.randn(C) * 0.1).astype(np.float32)
    w1 = (rng.randn(F, C) * C ** -0.5).astype(np.float32)  # nn.Linear [out, in]
    w2 = (rng.randn(C, F) * F ** -0.5).astype(np.float32)
    b1, b2 = (rng.randn(F) * 0.1).astype(np.float32), (rng.randn(C) * 0.1).astype(np.float32)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    args = (t(src).to(dtype), t(attn).to(dtype), t(g1), t(c1), t(w1).to(dtype).t(), t(b1),
            t(w2).to(dtype).t(), t(b2), t(g2), t(c2))
    return args


class _FakeLib:
    """Records the launch call; returns the error code it is given."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def fused_ffn_ln_launch(self, *a):
        self.calls.append(a)
        return self.err


def _patch_launch(monkeypatch, err=0):
    fake = _FakeLib(err)
    monkeypatch.setattr(kernels, "lib", lambda name: fake)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(kernels, "stream_arg", lambda device: 0)
    return fake


@pytest.mark.parametrize("dtype, C, F", [
    (torch.bfloat16, 256, 1024), (torch.float32, 256, 1024), (torch.bfloat16, 32, 64),
])
def test_wrapper_passes_its_body_to_the_launch(monkeypatch, dtype, C, F):
    fake = _patch_launch(monkeypatch)
    before = kernels.LAUNCHES["fused_ffn_ln"]
    args = _ffn_args(1, 40, C, F, dtype)
    out = fused_mlp.fused_ffn_ln_cuda(*args)
    assert out.shape == args[0].shape and out.dtype == dtype
    body, code, *_, ntok, c_arg, f_arg, eps, stream = fake.calls[0]
    assert body == fused_mlp.BODIES[fused_mlp.ffn_body(dtype, C, F)]
    assert code == kernels.dtype_code(args[0])
    assert (ntok, c_arg, f_arg) == (40, C, F)
    assert kernels.LAUNCHES["fused_ffn_ln"] == before + 1


def test_wrapper_raises_when_the_launch_refuses(monkeypatch):
    _patch_launch(monkeypatch, err=1)  # cudaErrorInvalidValue
    before = kernels.LAUNCHES["fused_ffn_ln"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        fused_mlp.fused_ffn_ln_cuda(*_ffn_args(1, 8, 256, 1024, torch.bfloat16))
    assert kernels.LAUNCHES["fused_ffn_ln"] == before


def test_wgmma_body_refuses_unaligned_tensors(monkeypatch):
    _patch_launch(monkeypatch)
    args = list(_ffn_args(1, 8, 256, 1024, torch.bfloat16))
    flat = torch.zeros(8 * 256 + 1, dtype=torch.bfloat16)
    args[0] = flat[1:].view(1, 8, 256)  # 2 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte"):
        fused_mlp.fused_ffn_ln_cuda(*args)


# ---------------------------------------------------------------------------
# refusals before the card
# ---------------------------------------------------------------------------

def _bad(kind):
    args = list(_ffn_args(1, 16, 32, 64, torch.bfloat16))
    if kind == "attn-shape":
        args[1] = args[1][:, :8]
    elif kind == "w1-shape":
        args[4] = args[4][:, :32]
    elif kind == "w2-shape":
        args[6] = args[6][:32]
    elif kind == "mixed-dtype":
        args[1] = args[1].float()
    elif kind == "weight-dtype":
        args[4] = args[4].float()
    elif kind == "b1-length":
        args[5] = args[5][:-1]
    elif kind == "g1-length":
        args[2] = torch.cat([args[2], args[2][:1]])
    elif kind == "c2-length":
        args[9] = args[9][:-1]
    return args


@pytest.mark.parametrize("kind, err, match", [
    ("attn-shape", ValueError, "shapes"), ("w1-shape", ValueError, "shapes"),
    ("w2-shape", ValueError, "shapes"), ("mixed-dtype", TypeError, "one dtype"),
    ("weight-dtype", TypeError, "one dtype"), ("b1-length", ValueError, "wrong length"),
    ("g1-length", ValueError, "wrong length"), ("c2-length", ValueError, "wrong length"),
    ("cpu-tensors", ValueError, "CUDA device"),
])
def test_wrapper_refusals(kind, err, match):
    with pytest.raises(err, match=match):
        fused_mlp.fused_ffn_ln_cuda(*_bad(kind))


# ---------------------------------------------------------------------------
# the bf16 law against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0.0, 100.0], ids=["centred", "offset-100"])
def test_bf16_law_matches_fused_ffn_ln(offset):
    C, F, S = 64, 128, 200  # 200 tokens: a ragged last block of 128
    args = _ffn_args(1, S, C, F, torch.bfloat16, seed=3, offset=offset)
    src, attn, g1, c1, w1, b1, w2, b2, g2, c2 = args
    j = lambda a: jnp.asarray(a.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    f = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    want = fused_ffn_ln(j(src), j(attn), {"scale": f(g1), "bias": f(c1)},
                        {"kernel": j(w1), "bias": f(b1)}, {"kernel": j(w2), "bias": f(b2)},
                        {"scale": f(g2), "bias": f(c2)}, block_tokens=128, interpret=True)
    got = fused_mlp.fused_ffn_ln_plain(*args)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-2 * scale, (err, scale)
    assert (got == want).mean() >= 0.98, (got == want).mean()
