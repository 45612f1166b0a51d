"""One run of one cell: set-up, the window, the comparison, the metrics.

``run_cell`` is the whole run behind ``benchmark/run.py``, with the look
for a card left to the caller, so that a test can drive it on the CPU
at a tiny configuration.  Set-up covers the seeded weights, the
program's model and driver, the inputs and one warm unit of the cell's
own shapes; the window runs the traffic's loop for ``seconds``.  A
traced run profiles its first units: ``trace_units`` with the device's
operations alone (busy time, the traced window), then
``attribute_units`` with the host's operators and the benchmark's
ranges too (device time by module, idle gaps by what the host did); the
rest of its window runs untraced.  Then the peak memory is read, the
program is freed, and the reference (float32, TF32 off) judges what the
window kept.
"""

from __future__ import annotations

import math
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import torch

from benchmark.harness import configs, weights
from benchmark.harness.spec import Cell, Spec
from benchmark.harness.trace import Ranges, Trace, record


@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    model: dict  # the configuration's ``model`` tree
    traffic: dict
    setup_s: float
    window_s: float
    work: Dict[str, float]
    spans: Dict[str, list]  # host-clock spans (s) of the untraced window
    trace: Optional[Trace] = None  # device operations only: busy time, the window
    attribution: Optional[Trace] = None  # with the host's operators and the bench. ranges
    extra: Dict[str, float] = field(default_factory=dict)


def _sync(device) -> Callable[[], None]:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _window(loop, seconds: float, sync, t0: float) -> None:
    """``begin``, ``step`` until ``seconds`` after ``t0``, ``end``."""
    loop.begin()
    while time.perf_counter() - t0 < seconds:
        loop.step()
    loop.end()
    sync()


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, controls: Sequence[str] = ()) -> Dict:
    """One run; returns the result object (before the import check).
    Each of ``controls`` (names from the kind's ``controls``: the
    reference in fp8, or a planted fault) adds its numbers under
    ``control_numbers`` and ``control_checks``: the same comparison with
    that side in the program's place (``benchmark/control.py``; the
    benchmark's own runs never compute them).  A cell on more cards than
    its kind runs on raises ``ValueError``."""
    sync = _sync(device)
    cell = spec.cell(workload)
    conf, traffic, limits = spec.config(cell.config), spec.traffic(cell.traffic), spec.limits(cell.name)
    kind = spec.loop(traffic["kind"])
    if cell.chips not in kind.chips:
        raise ValueError(f"{workload}: the {traffic['kind']} loop runs on {kind.chips} card(s), "
                         f"the cell asks for {cell.chips}")
    unknown = set(controls) - set(kind.controls)
    if unknown:
        raise ValueError(f"{workload}: no control {sorted(unknown)}; {kind.controls}")
    tree = conf["model"]
    pcfg, rcfg = configs.program_config(tree), configs.reference_config(tree)
    from benchmark.reference.univs import UniVSModel

    with torch.device("meta"):
        shapes = UniVSModel(rcfg)
    compute = torch.bfloat16 if tree.get("dtype") == "bfloat16" else torch.float32
    state = weights.seeded_state(shapes, seed, device, compute)
    ranges = Ranges(modules=trace)
    loop = kind(pcfg, rcfg, state, traffic, seed, seconds, device, ranges)
    loop.asked = tuple(controls)
    loop.setup()
    loop.arm()
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start

    tr = attr = None
    if trace:
        def traced(n):
            def part():
                before = loop.work()
                loop.begin()
                for _ in range(n - 1):
                    loop.step()
                loop.end()
                return {k: v - before.get(k, 0) for k, v in loop.work().items()}
            return part

        tr = record(traced(traffic["trace_units"]), sync, host_ops=False)
        ranges.tracing = True
        attr = record(traced(traffic["attribute_units"]), sync, host_ops=True)
        ranges.tracing = False
        ranges.remove_hooks()
        ranges.host = {}
    before = loop.work()
    _window(loop, seconds, sync, t0)
    window_s = time.perf_counter() - t0
    work = loop.work()
    cuda = torch.device(device).type == "cuda"
    peak = loop.peak_bytes() if cuda else 0
    run = Run(cell, tree, traffic, setup_s, window_s, work, ranges.host, tr, attr)
    run.extra.update(loop.extra())
    run.extra["rest"] = {k: work[k] - before.get(k, 0) for k in work}

    # the comparison, after the window and the peak: take the program's
    # side and free the program, then the reference judges it
    prog = loop.take()
    numbers = loop.judge(prog)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    ctl = {c: loop.judge(prog, c) for c in controls}

    metrics = {}
    for m in spec.metrics(cell.name, "per_layer" if trace else "end_to_end"):
        v = spec.reader(m.name)(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = power_limit()
    attempted = int(work.get("videos", work.get("steps", 0)))
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": 0 if correct else attempted, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = loop.busy_s(tr)
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": attr.idle_gaps(10)}
    if ctl:
        result["control_checks"] = {c: {k: {"value": n[k], "limit": limits[k]} for k in limits}
                                    for c, n in ctl.items()}
        result["control_numbers"] = ctl
    result["numbers"] = numbers
    result["host_spans"] = {k: v[:64] for k, v in ranges.host.items()}
    result["checks"] = checks
    return result
