"""Nothing under benchmark/ loads JAX or the JAX package, and nothing
reads bench.py, chip_smoke.py or tools/: every module is imported and a
tiny cell run in a fresh process, which then lists its modules and the
files it opened (an audit hook)."""

import json
import os
import subprocess
import sys

from benchmark.tests.tiny import ROOT

SCRIPT = r'''
import json, os, pkgutil, sys, time, importlib
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.path.insert(0, ROOT)
import benchmark
names = []
for m in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
        names.append(m.name)
import torch
torch.set_num_threads(2)
from benchmark.harness.cell import run_cell
from benchmark.harness.spec import Spec
from benchmark.tests.tiny import make_root
import tempfile
d = tempfile.mkdtemp()
spec = Spec(make_root(d))
for cell in ("vis-tiny", "vss-tiny"):
    r = run_cell(spec, cell, 7, 0.5, False, "cpu", time.perf_counter())
from benchmark.run import forbidden_modules
print(json.dumps({"modules": names, "tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": forbidden_modules(), "opened": opened}))
'''


def test_no_jax_and_no_developer_files():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT.replace("ROOT", repr(ROOT))],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "benchmark.run" in got["modules"] and "benchmark.harness.cell" in got["modules"]
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "univs_tpu"} & set(got["tops"])
    assert "univs_tpu_torch" in got["tops"]
    bad = [p for p in got["opened"]
           if os.path.basename(p) in ("bench.py", "chip_smoke.py")
           or os.path.abspath(p).startswith(os.path.join(ROOT, "tools") + os.sep)]
    assert bad == []
