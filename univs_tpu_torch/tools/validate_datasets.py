"""Preflight validation of on-disk dataset trees against the catalog
(counterpart of the JAX package's ``tools/validate_datasets.py``, with its
arguments, problem strings, printed lines and exit code).

The reference expects a specific ``datasets/`` layout (reference:
univs/data/datasets/builtin.py:27-614 and datasets/README.md); the port's
catalog (``univs_tpu_torch/data/datasets.py``) mirrors those relative
paths.  This tool checks a real tree BEFORE a long eval/train run:

  per dataset:
    - annotation JSON present (and parseable with the expected
      cocovid keys when --parse is given)
    - image root present
    - (--parse) first video's frame files exist under image_root
    - (--parse) category ids fit the dataset's namespace row count
      (``data/category_info.py``), so bank indexing cannot silently read
      the wrong rows

Usage:
  UNIVS_TPU_DATA_ROOT=/data python -m univs_tpu_torch.tools.validate_datasets
  python -m univs_tpu_torch.tools.validate_datasets --datasets ytvis_2021_dev,ovis_dev --parse

Host only: no model runs, so there is no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from univs_tpu_torch.data.datasets import data_root, get_spec, list_datasets


def check_one(name: str, parse: bool) -> List[str]:
    """Returns a list of problem strings (empty = OK)."""
    spec = get_spec(name)
    root = data_root()
    problems = []
    jp = os.path.join(root, spec.json_path)
    ir = os.path.join(root, spec.image_root)
    if spec.json_path and not os.path.isfile(jp):
        problems.append(f"missing annotation file {jp}")
    if not os.path.isdir(ir):
        problems.append(f"missing image root {ir}")
    if problems or not parse or not spec.json_path:
        return problems

    try:
        with open(jp) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unparseable JSON {jp}: {e}"]

    for key in ("videos", "annotations"):
        if key not in data:
            problems.append(f"{jp}: missing top-level key '{key}'")
    if problems:
        return problems

    vids = data["videos"]
    if vids:
        v0 = vids[0]
        fns = v0.get("file_names") or []
        missing = [fn for fn in fns[:5] if not os.path.isfile(os.path.join(ir, fn))]
        if missing:
            problems.append(f"first video's frames not under {ir}: e.g. {missing[0]}")
        if spec.has_expression and "expressions" not in v0 and "expressions" not in data:
            problems.append(f"{jp}: grounding dataset without expressions")

    if spec.namespace is not None and data.get("categories"):
        from univs_tpu_torch.data.category_info import COMBINED_DATASETS_CATEGORY_INFO

        count = COMBINED_DATASETS_CATEGORY_INFO[spec.namespace][0]
        bad = [c["id"] for c in data["categories"] if not (1 <= c["id"] <= count)]
        if bad:
            problems.append(f"{jp}: category ids outside namespace "
                            f"'{spec.namespace}' (1..{count}): {bad[:5]}")
    return problems


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", type=str, default=None,
                   help="comma-separated names (default: every registered dataset)")
    p.add_argument("--parse", action="store_true",
                   help="also parse JSONs and spot-check frame files / category ids")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    names = args.datasets.split(",") if args.datasets else list_datasets()
    ok = missing = bad = 0
    for name in names:
        try:
            problems = check_one(name, args.parse)
        except KeyError:
            print(f"?? {name}: not a registered dataset")
            bad += 1
            continue
        if not problems:
            print(f"ok {name}")
            ok += 1
        elif all(p.startswith("missing") for p in problems):
            print(f"-- {name}: " + "; ".join(problems))
            missing += 1
        else:
            print(f"!! {name}: " + "; ".join(problems))
            bad += 1
    print(f"\n{ok} ok, {missing} not on disk, {bad} broken "
          f"(root: {os.path.abspath(data_root())})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
