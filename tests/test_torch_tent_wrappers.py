"""The wrappers of kernels D (``msda_tent_base_cuda``), E
(``msda_tent_plane_cuda``) and F (``msda_tent_probe_cuda``) around the
card, on the CPU, with a stand-in library that records the launch (no
card is needed):

- each takes exactly the head sizes its kernel takes, a divisor or a
  multiple of 32 (``csrc/tent_gather.cuh:tent_head_ok``): a lane of the
  kernel reads a whole piece of a head's channels (16 or 32 bytes, or the
  whole head when it is narrower), and a head of any other width would
  leave a lane a ragged piece.  Every other D raises ``ValueError``
  before the launch and counts nothing;
- a head it takes reaches the launch with its arguments as the C
  interface orders them, and one launch is counted;
- the value (D) and the j-major slab (F) must be aligned to the
  min(16, D * size) bytes of a lane's loads; the d-major slab, read as
  aligned words around each element, need not be;
- a launch that returns an error raises and counts nothing;
- E's wrapper names the body it runs (``plane_body``: ``wgmma`` for
  bfloat16, ``fma`` for float32) and passes it to the launch beside the
  slab's dtype, which refuses a body that does not fit.
"""

import pytest
import torch

from univs_tpu_torch.ops import deformable_attention as da
from univs_tpu_torch.ops import kernels
from univs_tpu_torch.ops import msda_probes as mp

torch.set_num_threads(1)

ACCEPTED = (1, 2, 4, 8, 16, 32, 64, 96, 128)
REFUSED = (3, 6, 12, 24, 33, 48, 80)
SHAPES = ((2, 3), (1, 2))  # S = 8


class _FakeLib:
    """Records each launch call; returns the error code it is given."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def msda_tent_base_launch(self, *a):
        self.calls.append(a)
        return self.err

    def msda_tent_probe_launch(self, *a):
        self.calls.append(a)
        return self.err

    def msda_tent_plane_launch(self, *a):
        self.calls.append(a)
        return self.err


def _patch_launch(monkeypatch, err=0):
    fake = _FakeLib(err)
    monkeypatch.setattr(kernels, "lib", lambda name: fake)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(kernels, "stream_arg", lambda device: 0)
    return fake


def _base_args(D, mode, N=2, Lq=5, M=2, P=3):
    """Kernel D's arguments: mode 'int8' (slab, dequant, bf16 output) or a
    value dtype."""
    S, L = sum(h * w for h, w in SHAPES), len(SHAPES)
    loc = torch.zeros((N, Lq, M, L, P, 3))
    if mode == "int8":
        value = torch.zeros((N, S, M, D), dtype=torch.int8)
        return (value, SHAPES, loc, torch.ones((N, M, L)), torch.bfloat16)
    return (torch.zeros((N, S, M, D), dtype=getattr(torch, mode)), SHAPES, loc)


def _probe_args(D, law, layout, dtype=torch.bfloat16, N=1, R=8, M=2, H=3, W=4):
    use_wa = mp.PROBE_LAWS[law][0]
    slab = torch.zeros((N, M, W, H * D), dtype=dtype)
    xs = torch.zeros((N, R, M))
    return (slab, xs, xs, xs if use_wa else None, D, 4 if use_wa else 1, law, layout)


def test_head_sizes_are_the_kernels():
    """The one predicate both wrappers and both kernels share."""
    assert [d for d in range(1, 200) if kernels.tent_head_ok(d)] == [
        1, 2, 4, 8, 16, 32, 64, 96, 128, 160, 192]
    assert not kernels.tent_head_ok(0)


@pytest.mark.parametrize("mode", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("D", ACCEPTED + REFUSED)
def test_tent_base_head_sizes(monkeypatch, D, mode):
    fake = _patch_launch(monkeypatch)
    before = kernels.LAUNCHES["msda_tent_base"]
    args = _base_args(D, mode)
    if D in REFUSED:
        with pytest.raises(ValueError, match="head size"):
            da.msda_tent_base_cuda(*args)
        assert fake.calls == [] and kernels.LAUNCHES["msda_tent_base"] == before
        return
    out = da.msda_tent_base_cuda(*args)
    N, S, M, _ = args[0].shape
    _, Lq, _, L, P, _ = args[2].shape
    assert out.shape == (N, Lq, M * D)
    assert out.dtype == (torch.bfloat16 if mode == "int8" else args[0].dtype)
    (dtype, int8, value, dequant, loc, out_p, *dims, shapes, stream), = fake.calls
    assert (dtype, int8) == (kernels.dtype_code(out), int(mode == "int8"))
    assert (value, loc, out_p) == (args[0].data_ptr(), args[2].data_ptr(), out.data_ptr())
    assert dequant == (args[3].data_ptr() if mode == "int8" else None)
    assert dims == [N, S, Lq, M, D, P, L]
    assert list(shapes) == [v for hw in SHAPES for v in hw]
    assert kernels.LAUNCHES["msda_tent_base"] == before + 1


@pytest.mark.parametrize("layout", mp.SLAB_LAYOUTS)
@pytest.mark.parametrize("D", ACCEPTED + REFUSED)
def test_tent_probe_head_sizes(monkeypatch, D, layout):
    fake = _patch_launch(monkeypatch)
    before = kernels.LAUNCHES["msda_tent_probe"]
    law = "exp" if layout == "jmajor" else "base"
    args = _probe_args(D, law, layout)
    if D in REFUSED:
        with pytest.raises(ValueError, match="head size"):
            mp.msda_tent_probe_cuda(*args)
        assert fake.calls == [] and kernels.LAUNCHES["msda_tent_probe"] == before
        return
    out = mp.msda_tent_probe_cuda(*args)
    assert out.shape == (1, 2, 2, D) and out.dtype == torch.float32
    assert kernels.LAUNCHES["msda_tent_probe"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("law", list(mp.PROBE_LAWS))
def test_tent_probe_passes_its_law(monkeypatch, law, dtype):
    """The law's flags, rounding type and layout reach the launch."""
    fake = _patch_launch(monkeypatch)
    layout = "jmajor" if law.startswith("exp") else "dmajor"
    args = _probe_args(32, law, layout, dtype)
    out = mp.msda_tent_probe_cuda(*args)
    (code, round_bf16, slab, xs, ys, was, out_p, *dims, stream), = fake.calls
    use_wa, r_t1, r_ty, r_row, b16 = mp.PROBE_LAWS[law]
    assert (code, round_bf16) == (kernels.dtype_code(args[0]), int(b16))
    assert (slab, xs, out_p) == (args[0].data_ptr(), args[1].data_ptr(), out.data_ptr())
    assert was == (args[3].data_ptr() if use_wa else None)
    N, R, M, H, W, D, G, dmajor, flags = dims
    assert (N, R, M, H, W, D) == (1, 8, 2, 3, 4, 32)
    assert (G, dmajor) == (args[5], int(layout == "dmajor"))
    assert flags == use_wa * 1 + r_t1 * 2 + r_ty * 4 + r_row * 8


@pytest.mark.parametrize("which", ["base", "jmajor", "dmajor"])
def test_alignment_of_the_pieces(monkeypatch, which):
    """A value or j-major slab one element past an aligned address is
    refused; a d-major slab is not."""
    fake = _patch_launch(monkeypatch)
    if which == "base":
        flat = torch.zeros(2 * 8 * 2 * 32 + 1, dtype=torch.bfloat16)
        args = list(_base_args(32, "bfloat16"))
        args[0] = flat[1:].view(2, 8, 2, 32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            da.msda_tent_base_cuda(*args)
        assert fake.calls == []
        return
    args = list(_probe_args(32, "exp" if which == "jmajor" else "base", which))
    flat = torch.zeros(args[0].numel() + 1, dtype=args[0].dtype)
    args[0] = flat[1:].view(args[0].shape)
    if which == "jmajor":
        with pytest.raises(ValueError, match="16-byte aligned"):
            mp.msda_tent_probe_cuda(*args)
        assert fake.calls == []
    else:
        mp.msda_tent_probe_cuda(*args)
        assert len(fake.calls) == 1


@pytest.mark.parametrize("kernel", ["msda_tent_base", "msda_tent_probe", "msda_tent_plane"])
def test_wrapper_raises_when_the_launch_refuses(monkeypatch, kernel):
    _patch_launch(monkeypatch, err=1)  # cudaErrorInvalidValue
    before = kernels.LAUNCHES[kernel]
    with pytest.raises(RuntimeError, match="failed to launch"):
        if kernel == "msda_tent_base":
            da.msda_tent_base_cuda(*_base_args(32, "int8"))
        elif kernel == "msda_tent_probe":
            mp.msda_tent_probe_cuda(*_probe_args(32, "base", "dmajor"))
        else:
            mp.msda_tent_plane_cuda(torch.zeros((1, 2, 63, 8), dtype=torch.bfloat16),
                                    torch.zeros((1, 64, 24)), 64, 9, 4, "psum")
    assert kernels.LAUNCHES[kernel] == before


def test_plane_body_by_dtype():
    assert mp.plane_body(torch.bfloat16) == "wgmma"
    assert mp.plane_body(torch.float32) == "fma"
    with pytest.raises(TypeError):
        mp.plane_body(torch.float16)


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", mp.PLANE_MODES)
def test_wrapper_launches_its_body(monkeypatch, mode, dtype, window):
    """The launch gets the body's code, the slab's dtype code and the
    arguments in the C interface's order; one launch is counted."""
    fake = _patch_launch(monkeypatch)
    N, M, P, H, W, Qp, RQ, D, Hw, subq = 1, 2, 4, 7, 9, 128, 100, 8, 3, 64
    slab = torch.zeros((N, M, H * W, D), dtype=dtype)
    rows = torch.zeros((N, Qp, 3 * M * P))
    meta = torch.zeros((N, Qp // subq, M, 2), dtype=torch.int32) if window else None
    kw = dict(meta=meta, Hw=Hw, subq=subq) if window else {}
    before = kernels.LAUNCHES["msda_tent_plane"]
    out = mp.msda_tent_plane_cuda(slab, rows, RQ, W, P, mode, **kw)
    assert tuple(out.shape) == (N, RQ, M, D) and out.dtype == torch.float32
    (body, code, outer, *ptrs, stream), = fake.calls
    assert mp.PLANE_BODIES[body] == mp.plane_body(dtype) and code == kernels.dtype_code(slab)
    assert outer == int(mode == "outer") and stream == 0
    assert (ptrs[2] is None) == (not window)
    assert ptrs[4:] == [N, Qp, RQ, M, P, H, W, D, subq if window else 0, Hw if window else 0]
    assert kernels.LAUNCHES["msda_tent_plane"] == before + 1

