"""Ports of the JAX package's Pallas probes of ``tools/`` (the TPU's record
of which formulation of the MSDA bilinear sum its matrix unit favours).
Each module keeps its JAX probe's function names and, run as a script,
drives its probe's geometry on the card and prints one JSON record per
level and formulation:

    python -m univs_tpu_torch.tools.probe_tent_psum      # kernel E, 'psum', full and y-windowed
    python -m univs_tpu_torch.tools.probe_tent_outer     # kernel E, 'outer', full and y-windowed
    python -m univs_tpu_torch.tools.probe_tent_kernel    # kernel F, law 'kernel'
    python -m univs_tpu_torch.tools.probe_tent_variants  # kernel F, base / b16t1 / b16all / gridm
    python -m univs_tpu_torch.tools.probe_tent_v5        # kernel F, exp / exp-b16

A record holds the formulation's time per call (CUDA events over
``ITERS`` calls after ``WARMUP``; ``None`` on the CPU, where nothing is
timed), its error against the plain float32 gather law
(``msda_sample_plain``, in place of the JAX probes'
``ms_deform_attn_reference``) relative to the law's largest magnitude,
the tolerance it is held to, and the number of kernel calls it made.  The
same inputs also go through kernel A (``msda_sample``), in place of the
probes' "cur" production kernels.  The runners take ``device=None`` (the
card; raises without one) or ``"cpu"`` (the plain laws); a failure
raises, and nothing falls back to a plain version or to the CPU.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence, Tuple

import torch

from univs_tpu_torch.ops import deformable_attention as da

WARMUP, ITERS = 2, 10

# error against the float32 law, relative to its largest magnitude: one
# bf16 rounding of the plane, the taps or the output (~2 ulp), or a few
# along a probe's bf16 chain; float32 results differ in summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def time_ms(fn: Callable, device, iters: int = ITERS, warmup: int = WARMUP) -> Optional[float]:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``
    (CUDA events); None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / iters


def loc_from_qmajor(rows: torch.Tensor, RQ: int, M: int, P: int) -> torch.Tensor:
    """Query-major probe rows [N, Qp, 3*M*P] -> kernel A's
    [N, RQ, M, 1, P, 3] (x, y, weight) of one level."""
    N = rows.shape[0]
    parts = [rows[:, :RQ, k * M * P:(k + 1) * M * P].reshape(N, RQ, M, P) for k in range(3)]
    return torch.stack(parts, dim=-1)[:, :, :, None].contiguous()


def loc_from_pointminor(xs: torch.Tensor, ys: torch.Tensor, was: torch.Tensor,
                        P: int) -> torch.Tensor:
    """Point-minor sample rows [N, Q*P, M] each -> [N, Q, M, 1, P, 3]."""
    N, R, M = xs.shape
    parts = [t.reshape(N, R // P, P, M).permute(0, 1, 3, 2) for t in (xs, ys, was)]
    return torch.stack(parts, dim=-1)[:, :, :, None].contiguous()


def f32_law(value: torch.Tensor, hw: Tuple[int, int], loc: torch.Tensor) -> torch.Tensor:
    """The plain float32 gather law of one level: value [N, S, M, D] (any
    dtype, read in float32), loc [N, Q, M, 1, P, 3] -> [N, Q, M, D]."""
    N, _, M, D = value.shape
    return da.msda_sample_plain(value.float(), (hw,), loc).reshape(N, -1, M, D)


def measure(fn: Callable, want: torch.Tensor, tol: float, device: torch.device,
            **fields) -> dict:
    """Call ``fn`` once, hold its output (reshaped as ``want``) against
    the float32 law ``want``, then time it; one record."""
    got = fn().float().reshape(want.shape)
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / max(scale, 1e-12)
    finite = bool(torch.isfinite(got).all())
    ms = time_ms(fn, device)
    calls = 1 + (WARMUP + ITERS if ms is not None else 0)
    return dict(fields, ms=ms, err=err, law_max_abs=scale, tol=tol,
                **{"pass": finite and err <= tol}, calls=calls)


def kernel_a(value: torch.Tensor, hw: Tuple[int, int], loc: torch.Tensor, want: torch.Tensor,
             device: torch.device, **fields) -> dict:
    """The same inputs through kernel A (``msda_sample``; its plain law on
    the CPU), its output in the value's dtype."""
    return measure(lambda: da.msda_sample(value, (hw,), loc), want, TOL[value.dtype], device,
                   formulation="cur (kernel A)", kernel="msda_sample", **fields)


def print_records(records: Sequence[dict]) -> None:
    for r in records:
        print(json.dumps(r), flush=True)
