"""Timing-only variants of kernel E's bfloat16 body
(``csrc/msda_tent_plane.cu``, ``plane_wgmma_kernel``): what holds it.

    python -m univs_tpu_torch.tools.plane_variants

Each variant is the kernel's source with one or two lines replaced (the
replaced text must occur exactly once, so a change to the kernel makes
this script fail rather than measure something else), built by the same
nvcc command as the kernels, all in parallel, into
``build/plane_variants/``.  Each is timed through ``msda_tent_plane_cuda``
on the psum probe's 1/8 level (80 x 120, 5 frames, M = 8, P = 4, D = 32,
bf16), whole and with its Hw = 16 window, beside the source as it stands
(``committed``), in three rounds of 10 calls after 2 (the variants in
order, then reversed, then in order).  Variants:

  no_products  the ``wgmma`` products removed; each k-step's fragment is
               folded into the accumulator so that the walks stay
  no_walks     the fragments left zero (no footprint walk); the products run
  skeleton     neither: the footprint build, the V stream by TMA, the
               barriers and the stores
  bq192        blocks of 192 queries (three consumer warpgroups): at two
               blocks an SM a thread may hold ~78 registers, not ~56
  one_block    one block of 256 queries an SM (``__launch_bounds__(.., 1)``):
               no register cap below ~120, half the warps

Prints one JSON line a variant: ptxas's registers, spills and ``wgmma``
serialisation notes (C7511 / C7512) for ``plane_wgmma_kernel<*, 32>``,
the times (ms, a list per round, and their median), and the largest
difference from the committed output (the variants without products or
walks compute something else by design), then the card's name and power
limit.  Runs on the card only.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from univs_tpu_torch.ops import kernels
from univs_tpu_torch.ops import msda_probes as mp
from univs_tpu_torch.tools import probe_tent_psum, time_ms

NAME = "msda_tent_plane"
OUT_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "plane_variants")

_PRODUCT = ("      sm90::wgmma_m64nNk16_rs_tb<DP>(acc, af[ks], "
            "sm90::desc_nmajor<DP>(vs + ks * 16 * DP * 2));")
_FOLD = "      acc[ks] += __uint_as_float(af[ks][0] ^ af[ks][1] ^ af[ks][2] ^ af[ks][3]);"
_WALK = "        if ((int)cur[h].x < k0 + 16) take_pairs(lrow, idx[h], cur[h], k0, t, lo, hi);"

VARIANTS = {
    "committed": [],
    "no_products": [(_PRODUCT, _FOLD)],
    "no_walks": [(_WALK, "")],
    "skeleton": [(_PRODUCT, _FOLD), (_WALK, "")],
    "bq192": [("constexpr int kTcBQ = 256;", "constexpr int kTcBQ = 192;")],
    "one_block": [("__launch_bounds__(kTcThreads, DP == 64 ? 1 : 2)",
                   "__launch_bounds__(kTcThreads, 1)")],
}


def variant_source(edits) -> str:
    with open(os.path.join(kernels.CSRC, f"{NAME}.cu")) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{NAME}.cu no longer holds exactly one {old.strip()!r}")
        src = src.replace(old, new)
    return src


def build_all():
    """Build every variant in parallel; {name: (library, ptxas report of
    plane_wgmma_kernel<*, 32>)}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(OUT_DIR, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(edits))
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(kernels.nvcc_command(src, lib),
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    built = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        built[name] = (lib, ptxas_report(log))
    return built


def ptxas_report(log: str) -> dict:
    """Registers, spill bytes and wgmma notes of plane_wgmma_kernel<*, 32>
    (both modes) in an ``-Xptxas -v`` log."""
    rep = {"registers": [], "spill_stores": [], "notes": []}
    current = None
    for line in log.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(2)
        k32 = current is not None and "plane_wgmma_kernel" in current and "Li32E" in current
        note = re.search(r"\((C751\d)\).*function '(\w+)'", line)
        if note and "plane_wgmma_kernel" in note.group(2) and "Li32E" in note.group(2):
            rep["notes"].append(note.group(1))
        elif k32 and "spill stores" in line:
            rep["spill_stores"].append(int(re.search(r"(\d+) bytes spill stores", line).group(1)))
        elif k32 and "Used" in line and "registers" in line:
            rep["registers"].append(int(re.search(r"Used (\d+) registers", line).group(1)))
    return rep


def inputs():
    """The psum probe's 1/8 level and its Hw = 16 window meta (bf16)."""
    M, P, N, D, Hw, bqq, subq = 8, 4, 5, 32, 16, 2048, 512
    slab, rows, RQ, (H, W), _, _ = probe_tent_psum.level_inputs(
        probe_tent_psum.SHAPES, 0, M, P, N, D, np.random.RandomState(1), torch.device("cuda"),
        torch.bfloat16, bqq)
    meta = mp.window_meta(rows, M, P, H, W, Hw, bqq, subq)
    return dict(slab=slab, rows=rows, RQ=RQ, W=W, P=P, meta=meta, Hw=Hw, subq=subq)


def use_library(path: str) -> None:
    """Make ``msda_tent_plane_cuda`` launch through the library at ``path``."""
    handle = ctypes.CDLL(path)
    fn = getattr(handle, f"{NAME}_launch")
    fn.argtypes, fn.restype = kernels._SIGNATURES[NAME], ctypes.c_int
    kernels._libs[NAME] = handle


def main() -> int:
    if not torch.cuda.is_available():
        print("plane_variants: no CUDA device", file=sys.stderr)
        return 2
    built = build_all()
    x = inputs()
    calls = {
        "whole": lambda: mp.msda_tent_plane_cuda(x["slab"], x["rows"], x["RQ"], x["W"], x["P"],
                                                 "psum"),
        "window": lambda: mp.msda_tent_plane_cuda(x["slab"], x["rows"], x["RQ"], x["W"],
                                                  x["P"], "psum", meta=x["meta"], Hw=x["Hw"],
                                                  subq=x["subq"]),
    }
    recs = {name: {"variant": name, **rep, "ms": {k: [] for k in calls}}
            for name, (_, rep) in built.items()}
    outs = {}
    names = list(VARIANTS)
    for rnd in range(3):
        for name in names if rnd % 2 == 0 else names[::-1]:
            use_library(built[name][0])
            for key, fn in calls.items():
                outs[name, key] = fn()
                recs[name]["ms"][key].append(time_ms(fn, "cuda", iters=10))
    for name, rec in recs.items():
        rec["ms_median"] = {k: statistics.median(v) for k, v in rec["ms"].items()}
        rec["max_abs_diff"] = {k: float((outs[name, k] - outs["committed", k]).abs().max())
                               for k in calls}
        print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
