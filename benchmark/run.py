"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the compared numbers are also the last lines of standard error.
Without a CUDA card, with fewer cards than the cell asks for, or without
the program beside the benchmark, it exits non-zero and prints no
result; so it does if ``jax``, ``jaxlib``, ``flax`` or ``univs_tpu`` is
loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "univs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "univs_tpu_torch")):
        print("the program (univs_tpu_torch) is not beside the benchmark", file=sys.stderr)
        return 2

    import torch

    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                          T_START)
    except ValueError as e:  # a cell on a card count its loop does not run on
        print(str(e), file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
