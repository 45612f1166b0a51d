"""The ``train_ddp`` loop on four processes over gloo on the CPU, at the
tiny configuration (float32, where the program's plain laws and the
reference agree to rounding): a sound run is correct with ``rank_diff``
0 and the global loss the one-process reference's; the ``no_allreduce``
fault and the fp8 control break a limit; a traced run drives the other
ranks' traces; a rank that dies or stalls ends the run with an error
within its time limit and leaves no rank behind."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import ranks
from benchmark.harness.cell import run_cell
from benchmark.harness.spec import Spec
from benchmark.tests.test_bench_cells import TIGHT
from benchmark.tests.tiny import ROOT, make_root

SEED = 2 ** 31 + 77
CELL = "train-ddp-tiny"


def ddp_root(dst: str) -> str:
    """The tiny spec root with a four-rank cell of the tiny configuration
    (a global batch of 4 clips, one a rank)."""
    root = make_root(dst, "float32", TIGHT)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "traffic", "train_ddp_tiny.json"), "w") as f:
        json.dump({"kind": "train_ddp", "ranks": 4, "clips": 4, "frames": 2, "height": 64,
                   "width": 64, "slots": 6, "objects": 2, "blobs": 3, "batches": 3,
                   "trace_units": 2, "attribute_units": 1, "compare_steps": 3}, f)
    with open(os.path.join(b, "limits", f"{CELL}.json"), "w") as f:
        json.dump({k: TIGHT[k] for k in ("loss_gap", "grad_gap", "grad_dist", "update_med")}
                  | {"rank_diff": 0}, f)
    d = json.load(open(os.path.join(root, "BENCHMARK.json")))
    d["workloads"].append({"name": CELL, "config": "tiny", "traffic": "train_ddp_tiny",
                           "chips": 4, "why": "tests"})
    for m in d["end_to_end"] + d["per_layer"]:
        if "train-swinl-ddp4" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    json.dump(d, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    torch.set_num_threads(2)
    return Spec(ddp_root(str(tmp_path_factory.mktemp("ddp"))))


def test_sound_run_and_its_controls(spec):
    r = run_cell(spec, CELL, SEED, 1.0, False, "cpu", time.perf_counter(),
                 controls=("no_allreduce", "fp8"))
    assert r["correct"], r["checks"]
    assert r["numbers"]["rank_diff"] == 0 and r["numbers"]["loss_gap"] < TIGHT["loss_gap"]
    assert r["attempted"] >= 1 and set(r["metrics"]) == {"setup_s", "train_clips_per_s"}
    assert r["device"]["count"] == 0
    fault = r["control_checks"]["no_allreduce"]
    assert fault["rank_diff"]["value"] > 0
    assert fault["grad_dist"]["value"] > TIGHT["grad_dist"], fault
    fp8 = r["control_checks"]["fp8"]
    assert any(c["value"] > c["limit"] for c in fp8.values()), fp8


def test_traced_run(spec):
    """The other ranks trace the first traced part with rank 0 and report
    their busy time (0 on the CPU); the device readers find nothing."""
    r = run_cell(spec, CELL, SEED + 1, 1.0, True, "cpu", time.perf_counter())
    assert r["correct"] and r["device"]["busy_s"] == 0.0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not {"allreduce_ms.train", "collectives.train", "mfu.train"} & set(r["metrics"])


SCRIPT = r'''
import os, signal, sys, threading, time
sys.path.insert(0, REPO)
import torch
torch.set_num_threads(1)
from benchmark.harness import ranks
from benchmark.harness.cell import run_cell
from benchmark.harness.spec import Spec

spawned = []
popen = ranks.subprocess.Popen


def spy(*a, **k):
    p = popen(*a, **k)
    spawned.append(p)
    with open(PIDS, "a") as f:
        f.write(f"{p.pid}\n")
    return p


ranks.subprocess.Popen = spy


def fault():
    while len(spawned) < 3:
        time.sleep(0.1)
    time.sleep(DELAY)
    os.kill(spawned[1].pid, SIG)


threading.Thread(target=fault, daemon=True).start()
spec = Spec(SPEC)
spec.loop("train_ddp").stall_s = 20.0
run_cell(spec, "train-ddp-tiny", 5, 600.0, False, "cpu", time.perf_counter())
print("the run ended without the fault", flush=True)
'''


@pytest.mark.parametrize("sig,limit_s", [("SIGKILL", 60), ("SIGSTOP", 90)])
def test_a_rank_that_dies_or_stalls_ends_the_run(tmp_path, sig, limit_s):
    root = ddp_root(str(tmp_path))
    pids = tmp_path / "pids"
    script = (SCRIPT.replace("REPO", repr(ROOT)).replace("PIDS", repr(str(pids)))
              .replace("SPEC", repr(root)).replace("DELAY", "15")
              .replace("SIG", f"signal.{sig}"))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=limit_s + 60)
    took = time.monotonic() - t0
    assert out.returncode == ranks.EXIT_CODE, out.stderr[-3000:]
    assert "multi-card run failed" in out.stderr and took < limit_s, (took, out.stderr[-2000:])
    for pid in map(int, pids.read_text().split()):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
