"""On the card, at each cell's own size: the program's run is correct
and each of its controls (the reference in fp8, or a planted fault) is
not.  Skips without a card; ``python3 -m pytest benchmark/tests -m card``
runs them there (several minutes; the four-card cell skips on fewer cards)."""

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


@pytest.mark.card
def test_four_card_cell_is_correct_and_its_controls_are_not(card):
    """train-swinl-ddp4 on four cards: the program correct, rank_diff 0,
    and both controls (fp8; no_allreduce, each rank stepping on its own
    shard's gradient) break a limit."""
    import torch

    spec = Spec(ROOT)
    if torch.cuda.device_count() < spec.cell("train-swinl-ddp4").chips:
        pytest.skip("needs 4 CUDA cards")
    r = run_cell(spec, "train-swinl-ddp4", 2 ** 31 + 4243, 6.0, False, card, time.perf_counter(),
                 controls=("fp8", "no_allreduce"))
    assert r["correct"], r["checks"]
    assert r["numbers"]["rank_diff"] == 0
    for control, checks in r["control_checks"].items():
        assert any(c["value"] > c["limit"] for c in checks.values()), (control, checks)
