"""On the card, at each cell's own size: the program's run is correct
and each of its controls (the reference in fp8, or a planted fault) is
not.  Skips without a card; ``python3 -m pytest benchmark/tests -m card``
runs them there (several minutes)."""

import time

import pytest

from benchmark.harness.cell import run_cell
from benchmark.harness.spec import Spec
from benchmark.tests.tiny import ROOT

CASES = [("vis-r50", "fp8"), ("vis-r50", "prompt_skip"), ("vss-swinl", "fp8"),
         ("vss-swinl", "label_shift"), ("train-swinl", "fp8"), ("train-swinl", "half_batch")]


@pytest.mark.card
@pytest.mark.parametrize("cell,control", CASES)
def test_cell_is_correct_and_its_control_is_not(card, cell, control):
    spec = Spec(ROOT)
    r = run_cell(spec, cell, 2 ** 31 + 4242, 6.0, False, card, time.perf_counter(),
                 controls=(control,))
    assert r["correct"], r["checks"]
    checks = r["control_checks"][control]
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
