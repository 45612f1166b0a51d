"""The device trace and the benchmark's own ranges.

``Ranges`` opens ``torch.profiler`` ranges named ``bench.<name>`` from
the benchmark's side: around its calls into the program (``span``) and,
through forward pre-hooks and hooks, around the forward calls of named
modules of the program (``hook_modules``), so nothing in the program is
edited.  ``record`` runs a function under ``torch.profiler`` and reads the
exported trace into a ``Trace``: the device operations (kernels, copies,
sets) with their launch's host timestamp (joined by correlation id), and
the ``bench.`` ranges.  Device time inside a range is the time of the
kernels launched while it was open; busy time is the union of the device
operations' intervals (the arithmetic of ``chip_smoke.device_profile``'s
idle share, over the traced window).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."


@dataclass
class DeviceOp:
    name: str
    start: float  # us
    dur: float  # us
    cat: str
    launch: Optional[float]  # host timestamp (us) of the launching call


@dataclass
class Trace:
    ops: List[DeviceOp]
    ranges: List[Tuple[str, float, float]]  # (name without the prefix, start us, end us)
    window_s: float
    units: Dict[str, float] = field(default_factory=dict)  # work done in the traced window

    def busy_us(self) -> float:
        """Union of the device operations' intervals."""
        spans = sorted((o.start, o.start + o.dur) for o in self.ops)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def kernels(self, match: Callable[[str], bool]) -> List[DeviceOp]:
        return [o for o in self.ops if o.cat == "kernel" and match(o.name)]

    def range_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.ranges if n == name)

    def device_us_in(self, name: str) -> float:
        """Time of the kernels launched while a range ``name`` was open."""
        merged: List[List[float]] = []
        for s, e in sorted((s, e) for n, s, e in self.ranges if n == name):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [s for s, _ in merged]
        total = 0.0
        for o in self.ops:
            if o.cat != "kernel" or o.launch is None:
                continue
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and o.launch <= merged[i][1]:
                total += o.dur
        return total

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.dur * 1e-6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Gaps between device operations, summed by what the host was
        doing: the benchmark range that overlaps each gap most (the
        innermost among equals; "none" where no range overlaps it); the n
        largest sums, in seconds."""
        spans = sorted((o.start, o.start + o.dur) for o in self.ops)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        by: Dict[str, float] = {}
        for gs, ge in gaps:
            label, best = "none", (0.0, 0.0)
            for name, s, e in self.ranges:
                over = min(e, ge) - max(s, gs)
                if over > 0 and (over, -(e - s)) > best:
                    label, best = name, (over, -(e - s))
            by[label] = by.get(label, 0.0) + (ge - gs) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def parse_chrome_trace(events: List[dict], window_s: float) -> Trace:
    """Device operations and ``bench.`` ranges of a chrome trace."""
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
    ops, ranges = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            ops.append(DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), cat,
                                launch_ts.get(corr)))
        elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            s = float(e["ts"])
            ranges.append((e["name"][len(PREFIX):], s, s + float(e.get("dur", 0.0))))
    return Trace(ops, ranges, window_s)


class Ranges:
    """The benchmark's host-clock spans (always) and, while ``tracing``,
    the same spans as profiler ranges; with ``modules``, ranges around
    named modules' forward calls too (``hook_modules``)."""

    def __init__(self, modules: bool = False):
        self.modules = modules
        self.tracing = False
        self.host: Dict[str, List[float]] = {}
        self._hooks = []

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(PREFIX + name) if self.tracing else None
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def hook_modules(self, modules: Dict[str, torch.nn.Module]) -> None:
        """A profiler range ``bench.<name>`` around every forward call of
        each module while ``tracing`` (hooks only where ``modules``)."""
        if not self.modules:
            return
        for name, mod in modules.items():
            stack = []

            def pre(_m, _args, name=name, stack=stack):
                rf = torch.profiler.record_function(PREFIX + name) if self.tracing else None
                if rf is not None:
                    rf.__enter__()
                stack.append(rf)

            def post(_m, _args, _out, stack=stack):
                rf = stack.pop()
                if rf is not None:
                    rf.__exit__(None, None, None)

            self._hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

    def remove_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def record(fn: Callable[[], Dict[str, float]], sync: Callable[[], None],
           host_ops: bool) -> Trace:
    """Run ``fn`` (which returns the work it did, e.g. {"frames": 90})
    under ``torch.profiler`` and read its trace; the traced window runs
    from the profiler's start to ``sync`` after ``fn``.  ``host_ops``
    records the host's operators and the ``bench.`` ranges besides the
    device's operations and launches: it lengthens a host-bound window
    (by 69 % on vis-r50 against 19 % without, NVIDIA H100), so the busy
    time and the window come from a trace without them."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host_ops or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = fn()
        sync()
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    tr = parse_chrome_trace(events, window_s)
    tr.units = dict(units)
    return tr
