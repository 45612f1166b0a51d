"""Kernel E's footprint law on the CPU (``csrc/msda_tent_plane.cu``).

The kernel never evaluates the dense plane entry by entry: it builds each
query's plane row from the footprint of its points, the at most 4P
(pixel, term) pairs of the two columns and two rows around each point,
drops the taps outside the level, sums coincident pixels of two points in
point order from 0, sorts the pairs by pixel and rounds each sum to the
slab's dtype once.  Scattered into a zero plane, those pairs must equal
the plain plane ``tent_plane_plain`` bit for bit, in both modes and both
dtypes, on rows that put two points' taps on one pixel, taps past each
edge of the level, the probes' padding rows (x = -10) and rows of -10 in
every lane, negative weights, and integer coordinates (one tap an exact
zero).  The law is rebuilt here with numpy float32 scalars, one rounding
per step as the kernel's ``__f*_rn`` intrinsics.

A window that hits must hold its chunk's footprints: the kernel builds
them over the window's K range only."""

import numpy as np
import pytest
import torch

from univs_tpu_torch.ops import msda_probes as mp
from univs_tpu_torch.tools import probe_tent_psum

torch.set_num_threads(1)

H, W, M, P = 7, 9, 2, 4
F32 = np.float32


def _round(v, dtype):
    return F32(torch.tensor(v, dtype=torch.float32).to(dtype).to(torch.float32).item())


def _tent(i, c):
    """max(1 - |i - c|, 0) in float32, each step rounded."""
    return max(F32(1) - abs(F32(i) - c), F32(0))


def footprint(r, m, mode, dtype):
    """Query row ``r``'s footprint for head ``m``: sorted (pixel, float32
    sum) pairs, as the kernel builds them before rounding."""
    sums = {}
    for p in range(P):
        x, y, wa = (F32(r[k * M * P + m * P + p]) for k in range(3))
        x0 = int(min(max(np.floor(x), -2.0), W))
        y0 = int(min(max(np.floor(y), -2.0), H))
        tx = [_tent(x0, x), _tent(x0 + 1, x)]
        ty = [_tent(y0, y), _tent(y0 + 1, y)]
        if mode == "psum":
            ax, ay = tx, [F32(t * wa) for t in ty]
        else:
            ax, ay = [F32(t * wa) for t in tx], [_round(t, dtype) for t in ty]
        for dy in (0, 1):
            for dx in (0, 1):
                i, j = x0 + dx, y0 + dy
                if 0 <= i < W and 0 <= j < H:
                    s = j * W + i
                    sums[s] = F32(sums.get(s, F32(0)) + F32(ax[dx] * ay[dy]))
    return sorted(sums.items())


def scattered(rows, m, mode, dtype):
    """The footprints of ``rows`` [Q, 3*M*P], each sum rounded to
    ``dtype``, in a zero plane [Q, H*W] float32."""
    plane = torch.zeros((rows.shape[0], H * W), dtype=torch.float32)
    for q, r in enumerate(rows.numpy()):
        pairs = footprint(r, m, mode, dtype)
        assert len(pairs) <= 4 * P
        for s, v in pairs:
            plane[q, s] = float(_round(v, dtype))
    return plane


def edge_rows():
    """[Q, 3*M*P] float32: hand-placed points (head 0) and seeded ones
    (head 1, and the rest of head 0)."""
    rng = np.random.RandomState(7)
    pts = [
        # two points on the same four pixels, a third on two of them
        [(3.25, 2.5, 0.7), (3.75, 2.25, 0.3), (4.5, 2.5, 0.9), (3.25, 2.5, -0.4)],
        # taps past the left, right, top and bottom edges
        [(-0.4, 3.5, 0.8), (W - 0.3, 3.5, 0.6), (4.5, -0.7, 0.5), (4.5, H - 0.2, 0.9)],
        # the corners, and points far outside
        [(-0.5, -0.5, 1.0), (W - 0.5, H - 0.5, 1.0), (-5.5, 2.0, 1.0), (W + 3.0, H + 1.5, 1.0)],
        # integer coordinates: one tap an exact zero; on the edges as well
        [(2.0, 3.5, 0.6), (5.5, 4.0, 0.6), (0.0, 0.0, 0.6), (W - 1.0, H - 1.0, 0.6)],
        # x = -1 and y = -1: the inside tap's weight is 0
        [(-1.0, 2.5, 0.6), (3.5, -1.0, 0.6), (-2.0, -2.0, 0.6), (W, H, 0.6)],
        # negative weights, coincident with positive ones
        [(1.5, 1.5, -0.9), (1.5, 1.5, 0.9), (6.25, 5.75, -1e-3), (6.75, 5.25, -2.5)],
    ]
    rows = []
    for pp in pts:
        r = np.zeros((3, M, P), np.float32)
        r[:, 0] = np.asarray(pp, np.float32).T
        r[0, 1] = rng.uniform(-1.5, W + 0.5, P)
        r[1, 1] = rng.uniform(-1.5, H + 0.5, P)
        r[2, 1] = rng.uniform(-1.0, 1.0, P)
        rows.append(r.reshape(-1))
    # the probes' padding row (x far left, y mid-level, weight 0) and a
    # row of -10 in every lane
    pad = np.zeros((3, M, P), np.float32)
    pad[0], pad[1] = -10.0, float(H // 2)
    rows += [pad.reshape(-1), np.full(3 * M * P, -10.0, np.float32)]
    # seeded rows a little past every edge, weights of both signs
    rand = np.stack([rng.uniform(-1.5, W + 0.5, (24, M * P)), rng.uniform(-1.5, H + 0.5, (24, M * P)),
                     rng.uniform(-1.0, 1.0, (24, M * P))], axis=1).reshape(24, -1)
    return torch.as_tensor(np.concatenate([np.stack(rows), rand.astype(np.float32)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", mp.PLANE_MODES)
def test_footprint_plane_is_the_plain_plane(mode, dtype):
    rows = edge_rows()
    for m in range(M):
        want = mp.tent_plane_plain(rows, m, M, P, H, W, mode, dtype)
        got = scattered(rows, m, mode, dtype)
        assert torch.equal(got, want), (m, float((got - want).abs().max()))
        # the edge rows put entries where they should: coincident points
        # sum, the padding rows have none
        assert bool((want[:2] != 0).any()) and not bool((want[6:8] != 0).any())


@pytest.mark.parametrize("Hw", [3, 5])
def test_window_holds_the_footprints(Hw):
    """Each (frame, chunk, head) whose window hits has every footprint
    pixel of its chunk inside the window's rows: the kernel's K range
    drops nothing."""
    shapes, subq, bqq = ((H, W), (4, 5)), 8, 16
    loc, wa, hh, ww = probe_tent_psum.production_loc(shapes, 0, M, P, 1)
    rows = probe_tent_psum.rows_qmajor(loc, wa, hh, ww, bqq)
    meta = mp.window_meta(rows, M, P, H, W, Hw, bqq, subq).reshape(1, -1, M, 2)
    hits = 0
    for c in range(meta.shape[1]):
        for m in range(M):
            ystart, ok = (int(v) for v in meta[0, c, m])
            if not ok:
                continue
            hits += 1
            for r in rows[0, c * subq:(c + 1) * subq].numpy():
                for s, _ in footprint(r, m, "psum", torch.float32):
                    assert ystart * W <= s < min(H, ystart + Hw) * W
    assert 0 < hits < meta.shape[1] * M

