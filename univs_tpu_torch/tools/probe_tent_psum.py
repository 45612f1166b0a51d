"""Port of ``tools/probe_tent_psum.py``: the point-summed 2-D tent plane.

The MSDA output is linear in the P sampling points, so each query's
per-point tent planes can be summed into one plane row before the
product with the value:

    out[q, d] = ( sum_p wa_p tentx_p tenty_p )[q, :] @ v

This is kernel E (``ops/msda_probes.py:msda_tent_plane``, mode
``'psum'``) over the whole level (``msda_psum2d``) and over a y-window of
``Hw`` rows per chunk of queries with the whole level where a chunk
misses (``msda_psum2d_win``), beside kernel A on the same inputs, at the
probe's geometry: the 640x960 levels (80, 120), (40, 60), (20, 30), 5
frames, 8 heads, 4 points, D=32, a bf16 raster slab.

    python -m univs_tpu_torch.tools.probe_tent_psum
"""

from __future__ import annotations

import numpy as np
import torch

from univs_tpu_torch import tools
from univs_tpu_torch.ops import msda_probes
from univs_tpu_torch.utils.device import resolve_device

SHAPES = ((80, 120), (40, 60), (20, 30))
# window heights per level index (0 = 1/8), as the probe sweeps them
WINDOWS = {0: (8, 16, 24), 1: (8, 16)}


def msda_psum2d(slab_raster, rows, RQ, D, P, W, *, bqq=2048, subq=512):
    """slab_raster [N, M, S, D] float32 / bfloat16, rows [N, Qp, 3*M*P]
    float32 (``rows_qmajor``) -> [N, RQ, M, D] float32.  ``bqq`` and
    ``subq`` are the TPU kernel's tiles, kept for parity with the JAX
    probe: Qp must be a multiple of ``bqq``, and neither changes the
    result (nothing here to tune)."""
    if rows.shape[1] % bqq:
        raise ValueError(f"msda_psum2d: {rows.shape[1]} rows are not a multiple of {bqq}")
    return msda_probes.msda_tent_plane(slab_raster, rows, RQ, W, P, "psum")


def msda_psum2d_win(slab_raster, rows, RQ, D, P, W, Hw, *, bqq=2048, subq=512):
    """``msda_psum2d`` over a y-window of ``Hw`` rows per (chunk of
    ``subq`` queries, head), the whole level where the chunk misses ->
    (out [N, RQ, M, D] float32, meta [N, Qp / bqq, bqq / subq, M, 2] int32
    (ystart, ok))."""
    M = slab_raster.shape[1]
    H = slab_raster.shape[2] // W
    meta = msda_probes.window_meta(rows, M, P, H, W, Hw, bqq, subq)
    out = msda_probes.msda_tent_plane(slab_raster, rows, RQ, W, P, "psum", meta, Hw, subq)
    return out, meta


def production_loc(shapes, lid, M=8, P=4, N=5, seed=0):
    """The probe's sampling locations of level ``lid`` for every query of
    all levels (pixel centres plus a per-head ring of P points and noise)
    -> (loc [N, S, M, P, 2] in [0, 1] units, wa [N, S, M, P], hh, ww),
    float64 numpy, as the JAX probe draws them."""
    rng = np.random.RandomState(seed)
    base = np.concatenate([
        np.stack(np.meshgrid((np.arange(ww) + 0.5) / ww,
                             (np.arange(hh) + 0.5) / hh), -1).reshape(-1, 2)
        for hh, ww in shapes
    ])
    S = base.shape[0]
    thetas = np.arange(M) * (2 * np.pi / M)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    pts = grid[:, None, :] * (np.arange(P) + 1)[None, :, None]
    hh, ww = shapes[lid]
    off = pts[None, None] + rng.randn(N, S, M, P, 2) * 0.5
    loc = base[None, :, None, None, :] + off / np.array([ww, hh])
    wa = rng.rand(N, S, M, P)
    return loc, wa, hh, ww


def rows_pointminor(loc, wa, hh, ww):
    """-> (x, y, w) float32 [N, S*P, M] each, rows point-minor."""
    N, S, M, P, _ = loc.shape
    x = (loc[..., 0] * ww - 0.5).transpose(0, 1, 3, 2).reshape(N, S * P, M)
    y = (loc[..., 1] * hh - 0.5).transpose(0, 1, 3, 2).reshape(N, S * P, M)
    w = wa.transpose(0, 1, 3, 2).reshape(N, S * P, M)
    return tuple(torch.as_tensor(np.asarray(t, np.float32)) for t in (x, y, w))


def rows_qmajor(loc, wa, hh, ww, bqq=2048):
    """-> rows [N, Qp, 3*M*P] float32 (x, y, w lanes, point-minor within
    each), Qp padded to a multiple of ``bqq`` with inert queries: x far
    outside the level, y mid-range so that they do not move the window."""
    N, S, M, P, _ = loc.shape
    x = (loc[..., 0] * ww - 0.5).reshape(N, S, M * P)
    y = (loc[..., 1] * hh - 0.5).reshape(N, S, M * P)
    w = wa.reshape(N, S, M * P)
    rows = np.concatenate([x, y, w], axis=2)
    pad = (-S) % bqq
    if pad:
        fill = np.zeros((N, pad, rows.shape[2]))
        fill[:, :, : M * P] = -10.0
        fill[:, :, M * P: 2 * M * P] = float(hh // 2)
        rows = np.concatenate([rows, fill], axis=1)
    return torch.as_tensor(np.asarray(rows, np.float32))


def level_inputs(shapes, lid, M, P, N, D, rng, device, dtype, bqq):
    """One level's probe inputs on ``device``: (raster slab [N, M, S, D],
    rows [N, Qp, 3*M*P], RQ, (hh, ww), kernel A's value [N, S, M, D] and
    loc [N, RQ, M, 1, P, 3])."""
    loc, wa, hh, ww = production_loc(shapes, lid, M, P, N)
    rows = rows_qmajor(loc, wa, hh, ww, bqq).to(device)
    slab5 = rng.randn(N, M, hh, ww, D).astype(np.float32)
    slab = torch.as_tensor(slab5.reshape(N, M, hh * ww, D)).to(device=device, dtype=dtype)
    RQ = loc.shape[1]
    value = slab.permute(0, 2, 1, 3).contiguous()
    return slab, rows, RQ, (hh, ww), value, tools.loc_from_qmajor(rows, RQ, M, P)


def run(device=None, *, shapes=SHAPES, M=8, P=4, N=5, D=32, windows=WINDOWS,
        dtype=torch.bfloat16, bqq=2048, subq=512):
    """The probe at its geometry: per level (1/32, 1/16, 1/8), kernel A,
    the full plane and each window of ``windows``; a list of records."""
    dev = resolve_device(device)
    rng = np.random.RandomState(1)
    tol = tools.TOL[dtype]
    records = []
    for lid in (2, 1, 0):
        slab, rows, RQ, hw, value, loc = level_inputs(shapes, lid, M, P, N, D, rng, dev, dtype,
                                                      bqq)
        W = hw[1]
        want = tools.f32_law(value, hw, loc)
        level = dict(probe="psum", level=list(hw), dtype=str(dtype).replace("torch.", ""))
        records.append(tools.kernel_a(value, hw, loc, want, dev, **level))
        records.append(tools.measure(
            lambda: msda_psum2d(slab, rows, RQ, D, P, W, bqq=bqq, subq=subq), want, tol, dev,
            formulation="psum2d", kernel="msda_tent_plane", **level))
        for Hw in windows.get(lid, ()):
            meta = msda_probes.window_meta(rows, M, P, hw[0], W, Hw, bqq, subq)
            records.append(tools.measure(
                lambda Hw=Hw: msda_psum2d_win(slab, rows, RQ, D, P, W, Hw, bqq=bqq, subq=subq)[0],
                want, tol, dev, formulation="psum2d-win", kernel="msda_tent_plane", Hw=Hw,
                hit=float(meta[..., 1].float().mean()), **level))
    return records


def main():
    tools.print_records(run())


if __name__ == "__main__":
    main()
