"""Port of ``tools/probe_tent_sweep.py``: the sampling of one level at
production offset scales, with the y-window height swept.

The JAX probe builds sample rows as the encoder layer does at init
(reference-point centres in the queries' raster order over the 3-level
concat, a direction-grid ring of offsets in pixels of the sampled level,
0.5 px of noise: ``production_rows``) and sweeps, per level, the window
height ``Hw`` of the TPU's windowed tent kernel (``_tent_win_kernel``),
reporting its time and window hit rate (``hit_rate``: the share of
sample chunks whose rows fit the window, for the TPU kernel's block
geometry).  What maps to what here:

- ``_msda_tent_win_level`` at full height and ``_msda_tent2d_level`` (the
  whole level on one plane): kernel A (``msda_sample``), which gathers
  every level without a window, so it is the sweep's baseline;
- ``_msda_tent_win_level`` at ``Hw`` < H: kernel E's windowed plane
  (``ops/msda_probes.msda_tent_plane``, mode ``'psum'``, over
  ``window_meta``'s per-chunk windows of ``Hw`` rows; the whole level where
  a chunk misses), the card's only kernel with a y-window; and E over the
  whole level at ``Hw`` = H;
- the TPU's row chunk ``_TENT_SUB`` (2048 sample rows = 512 queries of 4
  points) and block ``_TENT_BQ`` (8192 rows): E's ``subq`` (queries a
  window) and ``bqq`` (queries a block); the JAX probe's ``sub=4096``
  sweep is E's ``subq=1024``.

Each record gives the time (CUDA events; None on the CPU), the error
against the float32 gather law, the hit rate of E's own block geometry
(``window_meta``'s ok flags) and the TPU geometry's ``hit_rate`` (the JAX
constants passed in as arguments).

    python -m univs_tpu_torch.tools.probe_tent_sweep [--levels 0 1]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from univs_tpu_torch import tools
from univs_tpu_torch.ops import msda_probes
from univs_tpu_torch.utils.device import resolve_device

SHAPES = ((80, 120), (40, 60), (20, 30))
# the TPU kernel's row chunk and block (univs_tpu/ops/deformable_attention.py:563-564)
TPU_TENT_SUB, TPU_TENT_BQ = 2048, 8192
# the JAX probe's windows per level index (0 = 1/8, 1 = 1/16); H itself is the full level
WINDOWS = {0: (16, 24, 32), 1: (12, 16, 20)}
BQQ, SUBQ = 2048, 512  # E's block and chunk, in queries
SUB_SWEEP = {0: (24, 1024)}  # level -> (Hw, subq): the JAX probe's sub=4096 at Hw=24


def production_rows(shapes, lid, M=8, P=4, N=5, seed=0):
    """xs/ys/was [N, R, M] float32 numpy for sampling level ``lid``, built
    like MSDeformAttnLayer at init: reference centers + direction-grid bias
    (pixels of the sampled level) + 0.5px learned-ish noise."""
    rng = np.random.RandomState(seed)
    base = np.concatenate([
        np.stack(np.meshgrid((np.arange(ww) + 0.5) / ww,
                             (np.arange(hh) + 0.5) / hh), -1).reshape(-1, 2)
        for hh, ww in shapes
    ])  # [S, 2] (x, y) normalized, query raster order
    S = base.shape[0]
    thetas = np.arange(M) * (2 * np.pi / M)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)  # [M, 2]
    pts = grid[:, None, :] * (np.arange(P) + 1)[None, :, None]  # [M, P, 2] px
    hh, ww = shapes[lid]
    off = pts[None, None] + rng.randn(N, S, M, P, 2) * 0.5  # px of level lid
    loc = base[None, :, None, None, :] + off / np.array([ww, hh])
    x = (loc[..., 0] * ww - 0.5).transpose(0, 1, 3, 2).reshape(N, S * P, M)
    y = (loc[..., 1] * hh - 0.5).transpose(0, 1, 3, 2).reshape(N, S * P, M)
    wa = rng.rand(N, S * P, M)
    return (np.asarray(x, np.float32), np.asarray(y, np.float32), np.asarray(wa, np.float32))


def hit_rate(ys, H, Hw, D, P, tent_sub=TPU_TENT_SUB, tent_bq=TPU_TENT_BQ):
    """Share of (frame, chunk, head) whose clipped rows fit a window of
    ``Hw`` rows starting at the chunk's lowest row, aligned down to a
    128-lane boundary of the j-major slab and clamped to ``H - Hw``: the
    TPU kernel's law for its chunk ``tent_sub`` and block ``tent_bq`` (in
    sample rows)."""
    align = max(1, -(-128 // D))
    sub = max(P, (tent_sub // P) * P)
    bq = max(sub, (tent_bq // sub) * sub)
    n, R, m = ys.shape
    pad = (-R) % bq
    ysp = np.concatenate([np.asarray(ys), np.full((n, pad, m), -10.0)], 1)
    nb = ysp.shape[1] // bq
    y0 = np.clip(np.floor(ysp), 0, H - 1).astype(np.int64)
    y0 = y0.reshape(n, nb, bq // sub, sub, m)
    ymin, ymax = y0.min(3), y0.max(3)
    ystart = np.minimum(ymin // align * align, H - Hw)
    return float((np.minimum(ymax + 1, H - 1) < ystart + Hw).mean())


def qmajor_rows(xs, ys, was, P, H, bqq=BQQ):
    """Point-minor rows [N, Q*P, M] each -> E's query-major rows [N, Qp,
    3*M*P] (x, y, w lanes, head-major, point-minor), Qp padded to a
    multiple of ``bqq`` with inert queries (x outside the level, y
    mid-range, weight 0)."""
    N, R, M = xs.shape
    Q = R // P
    lanes = [t.reshape(N, Q, P, M).transpose(0, 1, 3, 2).reshape(N, Q, M * P)
             for t in (xs, ys, was)]
    rows = np.concatenate(lanes, axis=2)
    pad = (-Q) % bqq
    if pad:
        fill = np.zeros((N, pad, rows.shape[2]), np.float32)
        fill[:, :, :M * P] = -10.0
        fill[:, :, M * P:2 * M * P] = float(H // 2)
        rows = np.concatenate([rows, fill], axis=1)
    return torch.as_tensor(np.ascontiguousarray(rows, np.float32))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--levels", type=int, nargs="*", default=[0, 1],
                   help="level indices (0 = 1/8, 1 = 1/16), as the JAX probe sweeps them")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run the plain laws")
    return p.parse_args(argv)


def report(records: List[dict], r: dict) -> None:
    """Append a record and print its line (time, hit rates, error)."""
    records.append(r)
    ms = "n/a" if r["ms"] is None else f"{r['ms']:6.2f} ms"
    hits = f"  hit={r['hit']:.2f}  tpu_hit={r['tpu_hit']:.2f}" if "hit" in r else ""
    sub = f" subq={r['subq']}" if "subq" in r else ""
    print(f"{r['formulation']:>15} Hw={r['Hw']:3d}{sub}: {ms}{hits}  err={r['err']:.5f}",
          flush=True)


def run(device=None, *, shapes=SHAPES, levels=(0, 1), M=8, P=4, N=5, D=32,
        windows=WINDOWS, sub_sweep=SUB_SWEEP, dtype=torch.bfloat16, bqq=BQQ,
        subq=SUBQ) -> List[dict]:
    """The sweep at its geometry: per level, kernel A, E over the whole
    level, E windowed at each height of ``windows`` (and at the (Hw, subq)
    of ``sub_sweep``); a list of records."""
    dev = resolve_device(device)
    rng = np.random.RandomState(1)
    tol = tools.TOL[dtype]
    records = []
    for lid in levels:
        hh, ww = shapes[lid]
        xs, ys, was = production_rows(shapes, lid, M, P, N)
        slab5 = rng.randn(N, M, hh, ww, D).astype(np.float32)
        slab = torch.as_tensor(slab5.reshape(N, M, hh * ww, D)).to(device=dev, dtype=dtype)
        value = slab.permute(0, 2, 1, 3).contiguous()
        rows = qmajor_rows(xs, ys, was, P, hh, bqq).to(dev)
        RQ = xs.shape[1] // P
        loc = tools.loc_from_qmajor(rows, RQ, M, P)
        want = tools.f32_law(value, (hh, ww), loc)
        level = dict(probe="sweep", level=[hh, ww], dtype=str(dtype).replace("torch.", ""))
        print(f"--- level 1/{8 * 2 ** lid} ({hh}x{ww}) ---", flush=True)
        report(records, tools.kernel_a(value, (hh, ww), loc, want, dev, Hw=hh, **level))
        report(records, tools.measure(
            lambda: msda_probes.msda_tent_plane(slab, rows, RQ, ww, P, "psum"), want, tol, dev,
            formulation="plane (full-H)", kernel="msda_tent_plane", Hw=hh, hit=1.0,
            tpu_hit=1.0, **level))
        cases = [(hw, subq) for hw in windows.get(lid, ())]
        cases += [sub_sweep[lid]] if lid in sub_sweep else []
        for hw, sq in cases:
            meta = msda_probes.window_meta(rows, M, P, hh, ww, hw, bqq, sq)
            report(records, tools.measure(
                lambda hw=hw, sq=sq, meta=meta: msda_probes.msda_tent_plane(
                    slab, rows, RQ, ww, P, "psum", meta, hw, sq),
                want, tol, dev, formulation="plane-win", kernel="msda_tent_plane", Hw=hw,
                subq=sq, hit=float(meta[..., 1].float().mean()),
                tpu_hit=hit_rate(ys, hh, hw, D, P, tent_sub=sq * P), **level))
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = parse_args(argv)
    records = run(args.device, levels=tuple(args.levels))
    tools.print_records(records)
    return records


if __name__ == "__main__":
    main()
