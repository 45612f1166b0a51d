"""Exact Hungarian assignment (Jonker-Volgenant shortest augmenting
paths) — counterpart of ``univs_tpu/losses/hungarian.py``.

The JAX package runs this algorithm on the TPU inside its jit.  Here
the matrices are at most 60 x 200 (pool slots x candidates: the 25
top-k candidates of the instance path, all 200 learnable queries of the
pixel path), so the port runs the same algorithm on a host copy of the
cost matrix: one device->host copy per clip; the assignment returns on
the input's device.  An on-device version is listed in ROADMAP.md.
``hungarian_batch`` solves a stack of problems (a training step's
layers x videos) from one host copy.

The arithmetic is float32, step for step as in the JAX version
(potentials, slack, first-index argmin), so the assignment is the same,
ties included.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_INF = np.float32(1e12)


def hungarian_numpy(cost: np.ndarray, row_valid: Optional[np.ndarray] = None) -> np.ndarray:
    """[N, M] float cost (N <= M) -> col4row [N] int64 (-1 for invalid rows)."""
    c = np.asarray(cost, np.float32)
    N, M = c.shape
    assert N <= M, "hungarian expects N (rows) <= M (cols)"
    if row_valid is not None:
        c = np.where(np.asarray(row_valid)[:, None], c, np.float32(0.0)).astype(np.float32)
    u = np.zeros(N + 1, np.float32)
    v = np.zeros(M + 1, np.float32)
    p = np.zeros(M + 1, np.int64)  # p[j]: row (1-based) matched to column j
    for i in range(N):
        p[0] = i + 1
        minv = np.full(M + 1, _INF, np.float32)
        used = np.zeros(M + 1, bool)
        way = np.zeros(M + 1, np.int64)
        j0 = 0
        while p[j0] != 0:
            used[j0] = True
            i0 = p[j0]
            cur = c[i0 - 1] - u[i0] - v[1:]
            unused = ~used[1:]
            better = unused & (cur < minv[1:])
            minv[1:] = np.where(better, cur, minv[1:])
            way[1:] = np.where(better, j0, way[1:])
            masked = np.where(unused, minv[1:], _INF)
            jm = int(np.argmin(masked))
            delta = masked[jm]
            u[p[used]] += delta
            v[used] -= delta
            minv[1:] = np.where(unused, minv[1:] - delta, minv[1:])
            j0 = jm + 1
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col4row = np.zeros(N + 1, np.int64)
    col4row[p[1:]] = np.arange(1, M + 1)
    col4row = col4row[1:] - 1
    if row_valid is not None:
        col4row = np.where(np.asarray(row_valid), col4row, -1)
    return col4row


def hungarian(cost: torch.Tensor, row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minimum-cost row -> column assignment: [N, M] (N <= M) ->
    col4row [N] int64 on ``cost``'s device (-1 for invalid rows).

    With no valid row the answer is all -1 whatever the walk does, so
    the walk and the cost's host copy are skipped (an empty entity pool:
    its N zero-cost rows tie on every column and would take N(N+1)/2
    phases)."""
    rv = None if row_valid is None else row_valid.detach().cpu().numpy()
    if rv is not None and not rv.any():
        return torch.full((cost.shape[0],), -1, dtype=torch.int64, device=cost.device)
    out = hungarian_numpy(cost.detach().to(torch.float32).cpu().numpy(), rv)
    return torch.as_tensor(out, device=cost.device)


def hungarian_batch(costs: torch.Tensor, row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A stack of assignments from ONE device->host copy of the costs:
    [..., N, M] (N <= M) -> col4row [..., N] int64 on ``costs``' device,
    each problem solved as ``hungarian``."""
    lead, (N, M) = costs.shape[:-2], costs.shape[-2:]
    c = costs.detach().to(torch.float32).cpu().numpy().reshape(-1, N, M)
    rv = (np.ones((c.shape[0], N), bool) if row_valid is None
          else np.broadcast_to(row_valid.detach().cpu().numpy(), (*lead, N)).reshape(-1, N))
    out = np.stack([hungarian_numpy(ci, vi) if vi.any() else np.full(N, -1, np.int64)
                    for ci, vi in zip(c, rv)]) if c.shape[0] else np.zeros((0, N), np.int64)
    return torch.as_tensor(out.reshape(*lead, N), device=costs.device)
