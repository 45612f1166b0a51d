"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration (``configs``,
whose ``file`` holds its sizes) and a traffic mix, the data file
``<bench>/traffic/<traffic>.json``, whose ``kind`` names the loop that
drives it, the class ``Loop`` of ``<bench>/kinds/<kind>.py``.  Its
comparison limits are
``<bench>/limits/<cell>.json``; every metric's reader is
``<bench>/metrics/<metric>.py``, a module with ``read(run)``.  ``<bench>``
is the first of ``paths``.  A later cell, mix, configuration or metric is
a new file and a new entry (a new kind of loop a new file); nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" | "per_layer"
    workloads: Optional[tuple]


class Spec:
    """The benchmark as ``BENCHMARK.json`` under ``root`` states it."""

    def __init__(self, root: str = REPO, file: str = "BENCHMARK.json"):
        self.root = root
        with open(os.path.join(root, file)) as f:
            self.data = json.load(f)
        self.bench = os.path.join(root, self.data["paths"][0])
        self._readers: Dict[str, Callable] = {}
        self._loops: Dict[str, type] = {}

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.bench, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]), w["why"])
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    def metrics(self, cell: str, kind: str) -> List[Metric]:
        """The ``kind`` metrics that ``cell`` reports: those whose
        ``workloads`` list names it, and those with no list."""
        out = []
        for m in self.data[kind]:
            wl = m.get("workloads")
            if wl is None or cell in wl:
                out.append(Metric(m["name"], m["unit"], m["better"], m["source"], kind,
                                  None if wl is None else tuple(wl)))
        return out

    def _module(self, folder: str, name: str):
        path = os.path.join(self.bench, folder, f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> Callable:
        """``read(run)`` of ``<bench>/metrics/<metric>.py``."""
        if metric not in self._readers:
            self._readers[metric] = self._module("metrics", metric).read
        return self._readers[metric]

    def loop(self, kind: str) -> type:
        """``Loop`` of ``<bench>/kinds/<kind>.py``."""
        if kind not in self._loops:
            self._loops[kind] = self._module("kinds", kind).Loop
        return self._loops[kind]
