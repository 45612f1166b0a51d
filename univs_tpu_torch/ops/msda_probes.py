"""The tent probes' laws: kernels E and F and their plain versions
(counterparts of the seven Pallas kernels of ``tools/probe_tent_*.py``).

The JAX package's ``tools/`` probes record which formulation of the MSDA
bilinear sum the TPU's matrix unit favours.  Two laws cover them, over
one level H x W with ``tent(c) = max(1 - |c|, 0)`` in float32:

- ``msda_tent_plane`` (kernel E, ``csrc/msda_tent_plane.cu``): the
  point-summed dense tent plane times the raster slab, modes ``'psum'``
  (``probe_tent_psum.py``) and ``'outer'`` (``probe_tent_outer.py``),
  over the whole level or a y-window per query chunk
  (``window_meta``);
- ``msda_tent_probe`` (kernel F, ``csrc/msda_tent_probe.cu``): the
  separable x-then-y tent per sample row with a probe's rounding
  points (``PROBE_LAWS``: ``probe_tent_kernel.py``,
  ``probe_tent_variants.py``, ``probe_tent_v5.py``).

Each has a plain version with the kernel's rounding order (``*_plain``)
and a card wrapper that counts its launches (``*_cuda``); the bare name
dispatches on the slab's device: CPU -> plain, CUDA -> the kernel or
raise.  Outputs are float32, as the probes return them.
"""

from __future__ import annotations

from typing import Optional

import torch

from univs_tpu_torch.ops import kernels

PLANE_MODES = ("psum", "outer")
SLAB_LAYOUTS = ("dmajor", "jmajor")

# law -> (multiply the x tent by wa, round t1, round the y tent, round each
# row before the point sum, round to bfloat16 whatever the slab's dtype);
# the rounding type is the slab's dtype otherwise
PROBE_LAWS = {
    "kernel": (False, False, False, False, False),  # probe_tent_kernel.tent_kernel
    "base": (True, False, False, True, True),       # probe_tent_variants base and gridm
    "b16t1": (True, True, False, True, True),
    "b16all": (True, True, True, True, True),
    "exp": (True, False, True, False, False),       # probe_tent_v5, b16p2=False
    "exp-b16": (True, True, True, False, False),    # probe_tent_v5, b16p2=True
}
_FLAG_BITS = (1, 2, 4, 8)  # csrc/msda_tent_probe.cu: kWa, kRoundT1, kRoundTy, kRoundRow

_F32 = torch.float32
# queries per plane in the plain version of kernel E: a whole 1/8-level
# plane of 5 frames would be 22 GB in float32
_PLANE_Q_CHUNK = 2048


def _tent(i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """max(1 - |i - c|, 0) in float32, each step rounded on its own."""
    return (1.0 - (i - c).abs()).clamp(min=0.0)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).to(_F32)


# ---------------------------------------------------------------------------
# kernel E: the point-summed tent plane
# ---------------------------------------------------------------------------


def window_meta(rows: torch.Tensor, M: int, P: int, H: int, W: int, Hw: int, bqq: int,
                subq: int) -> torch.Tensor:
    """(ystart, ok) per (frame, block of ``bqq`` queries, chunk of
    ``subq``, head) as the probes compute it (``probe_tent_psum.py:164-176``,
    ``probe_tent_outer.py:158-172``): the chunk's clipped tap rows
    ``[ymin, ymax + 1]`` fit the window ``[ystart, ystart + Hw)``, with
    ``ystart`` aligned so that ``ystart * W`` is a multiple of 8.
    -> int32 [N, Qp / bqq, bqq / subq, M, 2]."""
    n, Qp, _ = rows.shape
    if Qp % bqq or bqq % subq:
        raise ValueError(f"window_meta: {Qp} queries do not split into blocks of {bqq} "
                         f"and chunks of {subq}")
    y0c = torch.floor(rows[:, :, M * P:2 * M * P]).clamp(0, H - 1).to(torch.int32)
    y0b = y0c.reshape(n, Qp // bqq, bqq // subq, subq, M, P)
    ymin = y0b.amin(dim=(3, 5))
    ymax = y0b.amax(dim=(3, 5))
    align = 1
    while (W * align) % 8:
        align *= 2
    ystart = (ymin // align * align).clamp(max=(H - Hw) // align * align)
    ok = ((ymax + 1).clamp(max=H - 1) < ystart + Hw).to(torch.int32)
    return torch.stack([ystart, ok], dim=-1)


def tent_plane_plain(rows: torch.Tensor, m: int, M: int, P: int, H: int, W: int, mode: str,
                     dtype: torch.dtype) -> torch.Tensor:
    """Kernel E's plane for head ``m`` of the query rows [q, 3*M*P]
    float32 of one frame -> [q, H*W] float32, rounded to ``dtype``: from
    each point's x tents [q, W] and y tents [q, H] with the kernel's
    products, the points summed in order."""
    if mode not in PLANE_MODES:
        raise ValueError(f"mode must be one of {PLANE_MODES}, got {mode!r}")
    dev = rows.device
    ii = torch.arange(W, dtype=_F32, device=dev)
    jj = torch.arange(H, dtype=_F32, device=dev)
    MP = M * P
    x = rows[:, m * P:(m + 1) * P, None]
    y = rows[:, MP + m * P:MP + (m + 1) * P, None]
    wa = rows[:, 2 * MP + m * P:2 * MP + (m + 1) * P, None]
    tx, ty = _tent(ii, x), _tent(jj, y)  # [q, P, W], [q, P, H]
    if mode == "psum":
        ax, ay = tx, ty * wa
    else:
        ax, ay = tx * wa, _round(ty, dtype)
    acc = None
    for p in range(P):
        t = ay[:, p, :, None] * ax[:, p, None, :]  # [q, H, W]
        acc = t if acc is None else acc + t
    return _round(acc.reshape(-1, H * W), dtype)


def msda_tent_plane_plain(slab: torch.Tensor, rows: torch.Tensor, RQ: int, W: int, P: int,
                          mode: str) -> torch.Tensor:
    """Plain version of kernel E.  slab [N, M, S, D] float32 / bfloat16
    (raster, S = H*W); rows [N, Qp, 3*M*P] float32 -> [N, RQ, M, D]
    float32.  Per (frame, head) and chunk of queries it builds the plane
    (``tent_plane_plain``) and multiplies it with the value in float32.
    A window does not change the result, so this version has none."""
    if mode not in PLANE_MODES:
        raise ValueError(f"mode must be one of {PLANE_MODES}, got {mode!r}")
    N, M, S, D = slab.shape
    H = S // W
    out = torch.empty((N, RQ, M, D), dtype=_F32, device=slab.device)
    for n in range(N):
        for m in range(M):
            v = slab[n, m].to(_F32)  # [S, D]
            for q0 in range(0, RQ, _PLANE_Q_CHUNK):
                r = rows[n, q0:min(RQ, q0 + _PLANE_Q_CHUNK)]
                plane = tent_plane_plain(r, m, M, P, H, W, mode, slab.dtype)
                out[n, q0:q0 + plane.shape[0], m] = plane @ v
    return out


def _check_plane_args(slab, rows, RQ, W, P, mode, meta, Hw, subq):
    if mode not in PLANE_MODES:
        raise ValueError(f"mode must be one of {PLANE_MODES}, got {mode!r}")
    if slab.dim() != 4 or rows.dim() != 3:
        raise ValueError("msda_tent_plane: slab [N, M, S, D] and rows [N, Qp, 3*M*P]")
    N, M, S, D = slab.shape
    if S % W or tuple(rows.shape[::2]) != (N, 3 * M * P) or not 0 < RQ <= rows.shape[1]:
        raise ValueError(f"msda_tent_plane: rows {tuple(rows.shape)} do not match slab "
                         f"{tuple(slab.shape)} with W={W}, P={P}, RQ={RQ}")
    if rows.dtype != _F32:
        raise TypeError("msda_tent_plane: rows must be float32")
    if meta is not None and (meta.dtype != torch.int32 or not 0 < Hw <= S // W
                             or meta.numel() * subq != N * rows.shape[1] * M * 2):
        raise ValueError("msda_tent_plane: meta must be int32 [N, Qp / subq, M, 2] with "
                         "0 < Hw <= H")


PLANE_BODIES = ("fma", "wgmma")  # kernel E's bodies, by their launch code


def plane_body(dtype: torch.dtype) -> str:
    """The body kernel E runs for a slab of ``dtype``: ``"wgmma"`` for
    bfloat16 (the plane's A fragments built in registers from the
    footprints, ``wgmma`` from registers, V by TMA), ``"fma"`` for float32
    (the plane tile in shared memory, FMA products)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == _F32:
        return "fma"
    raise TypeError(f"msda_tent_plane: the slab must be float32 or bfloat16, got {dtype}")


def msda_tent_plane_cuda(slab: torch.Tensor, rows: torch.Tensor, RQ: int, W: int, P: int,
                         mode: str, meta: Optional[torch.Tensor] = None, Hw: int = 0,
                         subq: int = 0) -> torch.Tensor:
    """Kernel E on the card: the arguments of ``msda_tent_plane_plain``,
    all contiguous, and optionally the window: ``meta`` int32
    [N, Qp / subq, M, 2] (``window_meta``), its height ``Hw`` and chunk
    ``subq``.  Qp a multiple of 64, D a multiple of 8 up to 64, P <= 4,
    ``subq`` a multiple of 64.  Runs the body ``plane_body`` names."""
    _check_plane_args(slab, rows, RQ, W, P, mode, meta, Hw, subq)
    N, M, S, D = slab.shape
    kernels.require_cuda("msda_tent_plane", slab, rows, meta)
    if slab.data_ptr() % 16:
        raise ValueError("msda_tent_plane: the slab must be 16-byte aligned")
    out = torch.empty((N, RQ, M, D), dtype=_F32, device=slab.device)
    fn = kernels.lib("msda_tent_plane").msda_tent_plane_launch
    err = fn(PLANE_BODIES.index(plane_body(slab.dtype)), kernels.dtype_code(slab),
             int(mode == "outer"), slab.data_ptr(), rows.data_ptr(),
             None if meta is None else meta.data_ptr(), out.data_ptr(), N, rows.shape[1], RQ, M,
             P, S // W, W, D, subq, Hw, kernels.stream_arg(slab.device))
    kernels.check("msda_tent_plane", err)
    kernels.LAUNCHES["msda_tent_plane"] += 1
    return out


def msda_tent_plane(slab: torch.Tensor, rows: torch.Tensor, RQ: int, W: int, P: int, mode: str,
                    meta: Optional[torch.Tensor] = None, Hw: int = 0,
                    subq: int = 0) -> torch.Tensor:
    """[N, RQ, M, D] float32: plain version on the CPU, kernel E on CUDA."""
    if slab.is_cuda:
        return msda_tent_plane_cuda(slab, rows, RQ, W, P, mode, meta, Hw, subq)
    _check_plane_args(slab, rows, RQ, W, P, mode, meta, Hw, subq)
    return msda_tent_plane_plain(slab, rows, RQ, W, P, mode)


# ---------------------------------------------------------------------------
# kernel F: the separable tent per sample row
# ---------------------------------------------------------------------------


def slab_raster(slab: torch.Tensor, D: int, layout: str) -> torch.Tensor:
    """A probe slab [N, M, W, H*D] (``layout``) -> [N, M, H*W, D]."""
    N, M, W, HD = slab.shape
    H = HD // D
    if layout == "dmajor":
        v = slab.reshape(N, M, W, D, H).permute(0, 1, 4, 2, 3)
    else:
        v = slab.reshape(N, M, W, H, D).permute(0, 1, 3, 2, 4)
    return v.reshape(N, M, H * W, D)


def msda_tent_probe_plain(slab: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                          was: Optional[torch.Tensor], D: int, group: int, law: str,
                          layout: str) -> torch.Tensor:
    """Plain version of kernel F.  slab [N, M, W, H*D] float32 / bfloat16
    in ``layout`` (``'dmajor'``: element (i; d*H + j) = V[j, i, d];
    ``'jmajor'``: (i; j*D + d)); xs, ys, was [N, R, M] float32 (``was``
    None for the ``'kernel'`` law) -> [N, R / group, M, D] float32, the
    rows of each group of ``group`` consecutive rows summed.  Per sample:
    x taps ``mx = R(tent(i - x) [* wa])`` at the two columns around x,
    ``t1 = mx0 * v0 + mx1 * v1``, ``p2 = R(ty * t1)`` at the two rows
    around y, rounded where ``PROBE_LAWS[law]`` says."""
    use_wa, r_t1, r_ty, r_row, b16 = PROBE_LAWS[law]
    if layout not in SLAB_LAYOUTS:
        raise ValueError(f"layout must be one of {SLAB_LAYOUTS}, got {layout!r}")
    N, M, W, HD = slab.shape
    H = HD // D
    R = xs.shape[1]
    rt = torch.bfloat16 if b16 else slab.dtype
    v = slab_raster(slab, D, layout)
    x, y = xs.permute(0, 2, 1).to(_F32), ys.permute(0, 2, 1).to(_F32)  # [N, M, R]
    x0, y0 = torch.floor(x), torch.floor(y)
    taps = []
    for dx in (0, 1):
        i = x0 + dx
        tx = _tent(i, x)
        if use_wa:
            tx = tx * was.permute(0, 2, 1).to(_F32)
        taps.append((i, torch.where((i >= 0) & (i <= W - 1), _round(tx, rt), 0.0)))
    row = torch.zeros((N, M, R, D), dtype=_F32, device=slab.device)
    for dy in (0, 1):
        j = y0 + dy
        t1 = None
        for i, tx in taps:
            idx = (j.clamp(0, H - 1) * W + i.clamp(0, W - 1)).to(torch.int64)
            g = torch.gather(v, 2, idx[..., None].expand(N, M, R, D)).to(_F32)
            term = tx[..., None] * g
            t1 = term if t1 is None else t1 + term
        if r_t1:
            t1 = _round(t1, rt)
        ty = _tent(j, y)
        if r_ty:
            ty = _round(ty, rt)
        p2 = _round(ty[..., None] * t1, rt)
        row = row + torch.where(((j >= 0) & (j <= H - 1))[..., None], p2, 0.0)
    if r_row:
        row = _round(row, rt)
    row = row.reshape(N, M, R // group, group, D)
    acc = row[:, :, :, 0]
    for k in range(1, group):  # the kernel's order
        acc = acc + row[:, :, :, k]
    return acc.permute(0, 2, 1, 3).contiguous()


def _check_probe_args(slab, xs, ys, was, D, group, law, layout):
    if law not in PROBE_LAWS:
        raise ValueError(f"law must be one of {tuple(PROBE_LAWS)}, got {law!r}")
    if layout not in SLAB_LAYOUTS:
        raise ValueError(f"layout must be one of {SLAB_LAYOUTS}, got {layout!r}")
    if slab.dim() != 4 or slab.shape[3] % D:
        raise ValueError(f"msda_tent_probe: slab {tuple(slab.shape)} is not [N, M, W, H*{D}]")
    N, M = slab.shape[:2]
    R = xs.shape[1]
    for t in (xs, ys) + ((was,) if PROBE_LAWS[law][0] else ()):
        if t is None or tuple(t.shape) != (N, R, M) or t.dtype != _F32:
            raise ValueError(f"msda_tent_probe: xs, ys{', was' if PROBE_LAWS[law][0] else ''} "
                             f"must be float32 [{N}, R, {M}]")
    if R < 1 or R % group:
        raise ValueError(f"msda_tent_probe: {R} rows do not split into groups of {group}")


def msda_tent_probe_cuda(slab: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                         was: Optional[torch.Tensor], D: int, group: int, law: str,
                         layout: str) -> torch.Tensor:
    """Kernel F on the card: the arguments of ``msda_tent_probe_plain``,
    all contiguous; D a divisor or a multiple of 32 (any other D raises),
    a j-major slab aligned to the min(16, D * size) bytes a lane reads."""
    _check_probe_args(slab, xs, ys, was, D, group, law, layout)
    if not kernels.tent_head_ok(D):
        raise ValueError(f"msda_tent_probe: head size D={D} is neither a divisor nor a "
                         "multiple of 32")
    N, M, W, HD = slab.shape
    R = xs.shape[1]
    use_wa = PROBE_LAWS[law][0]
    kernels.require_cuda("msda_tent_probe", slab, xs, ys, was if use_wa else None)
    align = kernels.load_align(D, slab)
    if layout == "jmajor" and slab.data_ptr() % align:
        raise ValueError(f"msda_tent_probe: a j-major slab must be {align}-byte aligned")
    flags = sum(bit for bit, on in zip(_FLAG_BITS, PROBE_LAWS[law][:4]) if on)
    out = torch.empty((N, R // group, M, D), dtype=_F32, device=slab.device)
    fn = kernels.lib("msda_tent_probe").msda_tent_probe_launch
    err = fn(kernels.dtype_code(slab), int(PROBE_LAWS[law][4]), slab.data_ptr(), xs.data_ptr(),
             ys.data_ptr(), was.data_ptr() if use_wa else None, out.data_ptr(), N, R, M,
             HD // D, W, D, group, int(layout == "dmajor"), flags,
             kernels.stream_arg(slab.device))
    kernels.check("msda_tent_probe", err)
    kernels.LAUNCHES["msda_tent_probe"] += 1
    return out


def msda_tent_probe(slab: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    was: Optional[torch.Tensor], D: int, group: int, law: str,
                    layout: str) -> torch.Tensor:
    """[N, R / group, M, D] float32: plain version on the CPU, kernel F on
    CUDA."""
    if slab.is_cuda:
        return msda_tent_probe_cuda(slab, xs, ys, was, D, group, law, layout)
    _check_probe_args(slab, xs, ys, was, D, group, law, layout)
    return msda_tent_probe_plain(slab, xs, ys, was, D, group, law, layout)
