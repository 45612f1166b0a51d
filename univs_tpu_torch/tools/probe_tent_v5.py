"""Port of ``tools/probe_tent_v5.py``: the windowed separable tent with
the y tent rounded to the slab's dtype (the TPU probe expands it onto the
wide plane with a 0/1 matmul, which is exact).

Per sample row, ``mx = T(tent(i - x) * wa)``, ``t1 = mx @ V`` in f32,
``p2 = T(T(tent(j - y)) * t1)`` (``b16p2``: ``T(T(ty) * T(t1))``), rows
and points summed in f32.  The TPU kernel reads a y-window of ``Hw`` rows
per chunk where the chunk's samples fit it; that does not change the
function.  This is kernel F (``ops/msda_probes.py:msda_tent_probe``, laws
``'exp'`` and ``'exp-b16'``) over the j-major slab [N, M, W, H*D], beside
kernel A on the same inputs, at the probe's geometry: H, W = 80, 120, 5
frames, 8 heads, 4 points, D=32, 12,600 queries with clustered y, a bf16
slab.

    python -m univs_tpu_torch.tools.probe_tent_v5
"""

from __future__ import annotations

import numpy as np
import torch

from univs_tpu_torch import tools
from univs_tpu_torch.ops import msda_probes
from univs_tpu_torch.utils.device import resolve_device


def run_exp(slab_jmajor, xs, ys, was, D, P, Hw, b16p2):
    """slab_jmajor [N, M, W, H*D] (element (i; j*D + d) = V[j, i, d]),
    xs / ys / was [N, R, M] float32 point-minor -> [N, R / P, M, D]
    float32.  ``Hw`` (0 < Hw <= H) is the TPU kernel's window, kept for
    parity with the JAX probe: it does not change the result (nothing
    here to tune)."""
    H = slab_jmajor.shape[3] // D
    if not 0 < Hw <= H:
        raise ValueError(f"run_exp: window Hw={Hw} outside 1..{H}")
    return msda_probes.msda_tent_probe(slab_jmajor, xs, ys, was, D, P,
                                       "exp-b16" if b16p2 else "exp", "jmajor")


def run(device=None, *, H=80, W=120, D=32, M=8, P=4, N=5, Lq=12600, Hw=24,
        dtype=torch.bfloat16):
    """The probe at its geometry: kernel A and both ``b16p2`` values on
    one level of samples clustered around their query's row; a list of
    records."""
    dev = resolve_device(device)
    R = Lq * P
    rng = np.random.RandomState(0)
    slab = rng.randn(N, M, H, W, D).transpose(0, 1, 3, 2, 4).reshape(N, M, W, H * D)
    slab = torch.as_tensor(slab).to(dtype).to(dev)
    baseq = (np.arange(Lq) // W) % H * 1.0
    ys_n = np.broadcast_to(baseq[None, :, None, None], (N, Lq, P, M)) + rng.randn(N, Lq, P, M) * 2
    xs_n = rng.rand(N, Lq, P, M) * W
    xs, ys, was = (torch.as_tensor(np.asarray(a, np.float32)).to(dev)
                   for a in (xs_n.reshape(N, R, M), ys_n.reshape(N, R, M), rng.rand(N, R, M)))
    value = msda_probes.slab_raster(slab, D, "jmajor").permute(0, 2, 1, 3).contiguous()
    loc = tools.loc_from_pointminor(xs, ys, was, P)
    want = tools.f32_law(value, (H, W), loc)
    level = dict(probe="v5", level=[H, W], dtype=str(dtype).replace("torch.", ""), Hw=Hw)
    records = [tools.kernel_a(value, (H, W), loc, want, dev, **level)]
    for name, b16p2 in (("winexp", False), ("winexpb", True)):
        records.append(tools.measure(
            lambda b=b16p2: run_exp(slab, xs, ys, was, D, P, Hw, b), want, tools.TOL[dtype], dev,
            formulation=name, kernel="msda_tent_probe", **level))
    return records


def main():
    tools.print_records(run())


if __name__ == "__main__":
    main()
