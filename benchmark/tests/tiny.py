"""A tiny copy of the benchmark's data files for CPU tests: the real
``BENCHMARK.json`` with a tiny configuration and three tiny cells (VIS
and VSS, 8 frames at 64 x 96; training, 2 clips of 2 frames at 64 x 64)
added, as a later PR would add cells."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def tiny_model(dtype: str = "float32") -> dict:
    from benchmark.reference.config import UniVSConfig, tiny_test_config

    t = json.loads(json.dumps(dataclasses.asdict(tiny_test_config())))
    assert set(t) == {f.name for f in dataclasses.fields(UniVSConfig)}
    t["inference"]["num_frames_window"] = 8
    t["train"]["num_points"] = 64
    t["dtype"] = dtype
    return t


def make_root(dst: str, dtype: str = "float32", limits: dict = None) -> str:
    """A spec root under ``dst`` holding the tiny cells ``vis-tiny`` and
    ``vss-tiny``; returns it."""
    b = os.path.join(dst, "benchmark")
    for sub in ("configs", "traffic", "limits", "metrics", "kinds"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(b, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump({"name": "tiny", "source": "tests", "model": tiny_model(dtype), "assumed": [],
                   "reduced": []}, f)
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny", "source": "tests", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    common = {"frames": 8, "height": 64, "width": 96, "classes": 5, "capacity": 6,
              "max_videos_per_s": 4, "trace_units": 2, "attribute_units": 1, "check_clips": 2}
    for kind, cell in (("vis_stream", "vis-tiny"), ("vss_stream", "vss-tiny")):
        with open(os.path.join(b, "traffic", f"{kind}_tiny.json"), "w") as f:
            json.dump(dict(common, kind=kind), f)
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": f"{kind}_tiny",
                                  "chips": 1, "why": "tests"})
        src = "vis-r50" if kind == "vis_stream" else "vss-swinl"
        lim = json.load(open(os.path.join(BENCH, "limits", f"{src}.json")))
        if limits is not None:
            lim = {k: limits.get(k, v) for k, v in lim.items()}
        with open(os.path.join(b, "limits", f"{cell}.json"), "w") as f:
            json.dump(lim, f)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if src in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(b, "traffic", "train_tiny.json"), "w") as f:
        json.dump({"kind": "train_step", "clips": 2, "frames": 2, "height": 64, "width": 64,
                   "slots": 6, "objects": 2, "blobs": 3, "batches": 3, "trace_units": 2,
                   "attribute_units": 1, "compare_steps": 3}, f)
    spec["workloads"].append({"name": "train-tiny", "config": "tiny", "traffic": "train_tiny",
                              "chips": 1, "why": "tests"})
    with open(os.path.join(b, "limits", "train-tiny.json"), "w") as f:
        lim = json.load(open(os.path.join(BENCH, "limits", "train-swinl.json")))
        json.dump({k: (limits or {}).get(k, 1e9) for k in lim}, f)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "train-swinl" in m.get("workloads", ()):
            m["workloads"].append("train-tiny")
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return dst
