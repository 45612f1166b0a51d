"""Profiling / tracing helpers (counterpart of
``univs_tpu/utils/profiling.py``, which wraps ``jax.profiler``).

The reference has no custom tracing beyond d2's iteration timers; here
``trace`` captures a ``torch.profiler`` trace (the host's ops, and the
card's kernels when a card is present) into a TensorBoard-viewable file,
and ``StageTimer`` accumulates wall-clock stages of the clip-streaming
drivers, synchronising the device of what a stage produced before it
reads the clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a TensorBoard-viewable trace around a block: a
    ``*.pt.trace.json`` file written into ``log_dir`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _synchronize(x) -> None:
    """Wait for the device of every CUDA tensor in ``x`` (a tensor or a
    tuple of them)."""
    for t in x if isinstance(x, (list, tuple)) else (x,):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


class StageTimer:
    """Accumulating wall-clock stage timer (forces device sync)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(
                f"{k}: {self.totals[k]*1000:.1f} ms total, "
                f"{self.totals[k]/max(self.counts[k],1)*1000:.2f} ms/call x{self.counts[k]}"
            )
        return "\n".join(lines)
