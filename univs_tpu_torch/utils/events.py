"""Training event writer — the d2 EventStorage/JSON-writer analogue (the
port's copy of ``univs_tpu/utils/events.py``; reference: DefaultTrainer
hooks write metrics.json per iteration via CommonMetricPrinter/JSONWriter;
SURVEY §5 metrics/logging).

Writes one JSON object per logged step to ``{output}/metrics.jsonl``
with smoothed console printing.  Host-side only; values are fetched
(blocking) at the logging cadence, not every step, so the device
pipeline stays full between log points.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional


class EventWriter:
    def __init__(self, output_dir: Optional[str], print_every: int = 20,
                 smoothing: int = 20):
        self.print_every = print_every
        self._f = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()
        self._last_t = self._t0
        self._last_it = 0
        self._window: Dict[str, deque] = {}
        self._smoothing = smoothing

    def log(self, iteration: int, scalars: Dict[str, float]) -> None:
        vals = {k: float(v) for k, v in scalars.items()}
        for k, v in vals.items():
            self._window.setdefault(k, deque(maxlen=self._smoothing)).append(v)
        if self._f is not None:
            self._f.write(json.dumps({"iteration": iteration, **vals}) + "\n")
            self._f.flush()
        if iteration % self.print_every == 0:
            now = time.time()
            di = max(iteration - self._last_it, 1)
            it_s = di / max(now - self._last_t, 1e-9)
            self._last_t, self._last_it = now, iteration
            smoothed = {k: sum(w) / len(w) for k, w in self._window.items()}
            main = "  ".join(
                f"{k}: {v:.4f}" for k, v in sorted(smoothed.items())
                if k == "total_loss" or not k.startswith("loss_")
            )
            print(f"iter {iteration}  {main}  ({it_s:.2f} it/s)", flush=True)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
