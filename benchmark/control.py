"""The readings that a cell's comparison limits are set from.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 6 \
        [--controls fp8,half_batch]

For each seed, one run of the cell (a short window at the cell's own
load) whose comparison is made once for the program (the lower readings,
with ``correct`` at the cell's limits) and once for each control in the
program's place: the reference computed in fp8, or a fault planted in it
(the upper readings; the kind's ``controls`` name them, all by default).
One JSON line a seed; the benchmark's own runs never compute the
controls.  Needs the card, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--controls", default="", help="comma-separated; all of the kind's if empty")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import Spec

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    kind = spec.loop(spec.traffic(spec.cell(args.workload).traffic)["kind"])
    controls = [c for c in args.controls.split(",") if c] or list(kind.controls)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(spec, args.workload, seed, args.seconds, False, "cuda", t, controls=controls)
        print(json.dumps({"seed": seed, "correct": r["correct"], "metrics": r["metrics"],
                          "device": r["device"], "numbers": r["numbers"],
                          "control": r["control_numbers"]}), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
