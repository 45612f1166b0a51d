"""Port of ``tools/probe_tent_outer.py``: the point-summed 2-D tent plane
built as an outer product.

The TPU probe builds each point's plane from the narrow x tent
``tx = tent(i - x) * wa`` tiled along the rows and the narrow y tent
``ty = tent(j - y)``, rounded to the slab's dtype and expanded by a 0/1
matmul; the plane entry is ``(tent(i - x) * wa) * T(tent(j - y))``
summed over the points.  This is kernel E (``msda_tent_plane``, mode
``'outer'``) over the whole level (``msda_outer2d``) and over a y-window
of ``Hw`` rows per chunk of queries (``msda_outer2d_win``; the TPU
kernel sums the H / Hw static windows where a chunk misses, which is the
whole level), beside kernel A on the same inputs, at the probe's
geometry (as ``probe_tent_psum``).

    python -m univs_tpu_torch.tools.probe_tent_outer
"""

from __future__ import annotations

import numpy as np
import torch

from univs_tpu_torch import tools
from univs_tpu_torch.ops import msda_probes
from univs_tpu_torch.tools.probe_tent_psum import (SHAPES, level_inputs, production_loc,
                                                   rows_pointminor, rows_qmajor)
from univs_tpu_torch.utils.device import resolve_device

__all__ = ["msda_outer2d", "msda_outer2d_win", "production_loc", "rows_pointminor",
           "rows_qmajor", "run", "main"]

# level indices (0 = 1/8) of the full plane, and window heights per level
FULL_LEVELS = (1, 2)
WINDOWS = {0: (16, 20), 1: (8, 20)}


def msda_outer2d(slab_raster, rows, RQ, D, P, W, *, bqq=2048, subq=512):
    """slab_raster [N, M, S, D] float32 / bfloat16, rows [N, Qp, 3*M*P]
    float32 (``rows_qmajor``) -> [N, RQ, M, D] float32.  ``bqq`` and
    ``subq`` are the TPU kernel's tiles, kept for parity with the JAX
    probe: Qp must be a multiple of ``bqq``, and neither changes the
    result (nothing here to tune)."""
    if rows.shape[1] % bqq:
        raise ValueError(f"msda_outer2d: {rows.shape[1]} rows are not a multiple of {bqq}")
    return msda_probes.msda_tent_plane(slab_raster, rows, RQ, W, P, "outer")


def msda_outer2d_win(slab_raster, rows, RQ, D, P, W, Hw, *, bqq=2048, subq=512):
    """``msda_outer2d`` over a y-window of ``Hw`` rows (H a multiple of
    Hw) -> (out [N, RQ, M, D] float32, meta [N, Qp / bqq, bqq / subq, M, 2]
    int32 (ystart, ok))."""
    M = slab_raster.shape[1]
    H = slab_raster.shape[2] // W
    if H % Hw:
        raise ValueError(f"msda_outer2d_win: H={H} is not a multiple of Hw={Hw}")
    meta = msda_probes.window_meta(rows, M, P, H, W, Hw, bqq, subq)
    out = msda_probes.msda_tent_plane(slab_raster, rows, RQ, W, P, "outer", meta, Hw, subq)
    return out, meta


def run(device=None, *, shapes=SHAPES, M=8, P=4, N=5, D=32, full_levels=FULL_LEVELS,
        windows=WINDOWS, dtype=torch.bfloat16, bqq=2048, subq=512):
    """The probe at its geometry: per level (1/32, 1/16, 1/8), kernel A,
    the full plane on ``full_levels`` and each window of ``windows`` that
    divides the level's height; a list of records."""
    dev = resolve_device(device)
    rng = np.random.RandomState(1)
    tol = tools.TOL[dtype]
    records = []
    for lid in (2, 1, 0):
        slab, rows, RQ, hw, value, loc = level_inputs(shapes, lid, M, P, N, D, rng, dev, dtype,
                                                      bqq)
        W = hw[1]
        want = tools.f32_law(value, hw, loc)
        level = dict(probe="outer", level=list(hw), dtype=str(dtype).replace("torch.", ""))
        records.append(tools.kernel_a(value, hw, loc, want, dev, **level))
        if lid in full_levels:
            records.append(tools.measure(
                lambda: msda_outer2d(slab, rows, RQ, D, P, W, bqq=bqq, subq=subq), want, tol,
                dev, formulation="outer2d", kernel="msda_tent_plane", **level))
        for Hw in windows.get(lid, ()):
            if hw[0] % Hw:
                continue
            meta = msda_probes.window_meta(rows, M, P, hw[0], W, Hw, bqq, subq)
            records.append(tools.measure(
                lambda Hw=Hw: msda_outer2d_win(slab, rows, RQ, D, P, W, Hw, bqq=bqq,
                                               subq=subq)[0],
                want, tol, dev, formulation="outer2d-win", kernel="msda_tent_plane",
                Hw=Hw, hit=float(meta[..., 1].float().mean()), **level))
    return records


def main():
    tools.print_records(run())


if __name__ == "__main__":
    main()
