"""The port's counterparts of the repository's ``tools/``: the user entry
points, the measurement tools and the Pallas probes.

    python -m univs_tpu_torch.tools.run_net --eval-only | --train ...  # train_net.py
    torchrun --nproc_per_node N -m univs_tpu_torch.tools.run_net --train ...
    python -m univs_tpu_torch.tools.demo --input video.mp4 ...         # overlays
    python -m univs_tpu_torch.tools.extract_class_embeddings --names names.txt ...
    python -m univs_tpu_torch.tools.semantic_feature_to_mask features.npz --weights ...
    python -m univs_tpu_torch.tools.show_results --results results.json ...
    python -m univs_tpu_torch.tools.validate_datasets [--parse]
    python -m univs_tpu_torch.tools.analyze_model [--backbone resnet50]
    python -m univs_tpu_torch.tools.bench_serving [B ...]     # BatchedVISServer
    python -m univs_tpu_torch.tools.bench_occupancy           # EntityDriver, pool filled
    python -m univs_tpu_torch.tools.profile_stages            # backbone / encode / forward
    python -m univs_tpu_torch.tools.profile_gather            # pixel-decoder pieces
    python -m univs_tpu_torch.tools.probe_tent_sweep          # A per level, E's window sweep

Each runs on the card unless ``--device cpu`` is given (raises without a
card), at the size its flags give: none of them picks a smaller run or the
CPU because no card is present.  Times on the card are CUDA events after a
synchronise (``stage_ms``).

The probes are the TPU's record of which formulation of the MSDA bilinear
sum its matrix unit favours.  Each probe module keeps its JAX probe's
function names and, run as a script,
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
import time
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


def stage_ms(fn: Callable, device, iters: int = 5, warmup: int = 1) -> float:
    """Mean ms per call of ``fn``: CUDA events over ``iters`` calls after
    ``warmup`` and a synchronise on the card; the host clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    return time_ms(fn, device, iters, 0)


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
