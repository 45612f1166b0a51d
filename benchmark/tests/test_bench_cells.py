"""Whole runs of tiny cells on the CPU: a sound run is correct; with the
timed path broken underneath, or with the fp8 control in the program's
place, ``correct`` comes out false; a cell, a mix, a configuration and a
metric added as files alone run.

The tiny configuration runs in float32, where the program's plain laws
on the CPU and the reference agree to rounding, so the limits here are
tight (1e-4); the cells' own limits (``limits/*.json``) are set from
the card's readings."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark.harness.cell import run_cell
from benchmark.harness.spec import Spec
from benchmark.tests.tiny import make_root

TIGHT = {"logit_ratio": 100, "mask_ratio": 100, "embd_ratio": 100, "proca_ratio": 100,
         "start_diff": 0, "step_diff": 0,
         "drain_diff": 0, "label_gap": 1e-3, "loss_gap": 1e-4, "grad_gap": 1e-3,
         "grad_dist": 1e-3, "update_med": 1e-2}
E2E = {"vis-tiny": "vis_fps", "vss-tiny": "vss_fps", "train-tiny": "train_clips_per_s"}
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    torch.set_num_threads(2)
    return Spec(make_root(str(tmp_path_factory.mktemp("tiny")), "float32", TIGHT))


def run(spec, cell, seed=SEED, **kw):
    return run_cell(spec, cell, seed, 1.0, False, "cpu", time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", list(E2E))
def test_sound_run_is_correct(spec, cell):
    r = run(spec, cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", E2E[cell]}


@pytest.mark.parametrize("cell,control", [
    ("vis-tiny", "fp8"), ("vis-tiny", "prompt_skip"),
    ("vss-tiny", "fp8"), ("vss-tiny", "label_shift"), ("train-tiny", "fp8"),
    ("train-tiny", "half_batch")])
def test_control_is_not_correct(spec, cell, control):
    r = run(spec, cell, controls=(control,))
    assert r["correct"]
    checks = r["control_checks"][control]
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_witness_computes_in_the_compute_dtype(spec):
    """The training witness (the reference in the compute dtype over
    float32 masters) runs; in a float32 configuration it is the reference."""
    r = run(spec, "train-tiny", controls=("witness_bf16",))
    n = r["control_numbers"]["witness_bf16"]
    assert n["loss_gap"] == 0 and n["grad_dist"] == 0 and n["update_med"] == 0, n


def test_unknown_control_and_card_count_are_refused(spec, tmp_path):
    with pytest.raises(ValueError, match="no control"):
        run(spec, "vss-tiny", controls=("half_batch",))
    root = make_root(str(tmp_path), "float32", TIGHT)
    d = json.load(open(os.path.join(root, "BENCHMARK.json")))
    d["workloads"].append({"name": "vss-tiny4", "config": "tiny", "traffic": "vss_stream_tiny",
                           "chips": 4, "why": "four cards"})
    json.dump(d, open(os.path.join(root, "BENCHMARK.json"), "w"))
    lim = os.path.join(root, "benchmark", "limits")
    shutil.copy(os.path.join(lim, "vss-tiny.json"), os.path.join(lim, "vss-tiny4.json"))
    with pytest.raises(ValueError, match="runs on"):
        run(Spec(root), "vss-tiny4")


@pytest.mark.parametrize("cell", ["vis-tiny", "vss-tiny"])
def test_answer_altered_where_produced(spec, cell, monkeypatch):
    """The decoder's outputs altered by 1 % where the decoder produces them."""
    from univs_tpu_torch.models.decoder import UniVSDecoder

    forward = UniVSDecoder.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        for k in ("pred_logits", "pred_masks", "pred_embds"):
            out[k] = out[k] * 1.01
        return out

    monkeypatch.setattr(UniVSDecoder, "forward", altered)
    r = run(spec, cell)
    assert not r["correct"] and r["checks"]["logit_ratio"]["value"] > TIGHT["logit_ratio"]


def test_prompt_path_altered_in_the_program(spec, monkeypatch):
    """The program's prompt cross-attention alters its prompt rows by 1 %:
    the first prompt cross-attention's number fails."""
    import torch as t

    from univs_tpu_torch.models.decoder import UniVSDecoder

    proca = UniVSDecoder._proca

    def altered(self, i, output, *a, **k):
        new = proca(self, i, output, *a, **k)
        Ql = self.num_queries
        return t.cat([new[:, :Ql], new[:, Ql:] * 1.01], dim=1)

    monkeypatch.setattr(UniVSDecoder, "_proca", altered)
    r = run(spec, "vis-tiny")
    assert not r["correct"] and r["checks"]["proca_ratio"]["value"] > TIGHT["proca_ratio"]


def test_drain_that_serves_a_slot_the_pool_does_not_hold(spec, monkeypatch):
    """The drain adds a result for a slot that is not valid."""
    from univs_tpu_torch.inference import driver

    assemble = driver.assemble_vis_results

    def extra(emitted, starts, scores, valid, quality, V, out_size, rows):
        got = assemble(emitted, starts, scores, valid, quality, V, out_size, rows)
        free = int(np.flatnonzero(~valid)[0])
        blank = driver.rle.encode(np.zeros(out_size, np.uint8))
        return got + [dict(obj_id=free, segmentations=[blank] * V)]

    monkeypatch.setattr(driver, "assemble_vis_results", extra)
    r = run(spec, "vis-tiny")
    assert not r["correct"] and r["checks"]["drain_diff"]["value"] >= 1


def test_label_law_that_alters_its_answer(spec, monkeypatch):
    """The VSS labels moved on by one class where the label law makes them."""
    from univs_tpu_torch.inference import driver

    law = driver.vss_semantic_labels

    def shifted(pred_logits, *a, **k):
        return (law(pred_logits, *a, **k) + 1) % pred_logits.shape[-1]

    monkeypatch.setattr(driver, "vss_semantic_labels", shifted)
    r = run(spec, "vss-tiny")
    assert not r["correct"] and r["checks"]["label_gap"]["value"] > TIGHT["label_gap"]


def test_clip_step_that_returns_its_state_unchanged(spec, monkeypatch):
    """A clip step that leaves the pool as it found it: run on the same
    pool, features and decoder outputs, the reference's step changes it."""
    from univs_tpu_torch.inference import driver

    monkeypatch.setattr(driver, "entity_clip_step", lambda *a, **k: a[2])
    r = run(spec, "vis-tiny")
    assert not r["correct"] and r["checks"]["step_diff"]["value"] > 0


def test_train_step_that_returns_its_state_unchanged(spec, monkeypatch):
    """The optimizer leaves the masters as they were: every leaf the
    reference moves reads 1."""
    from univs_tpu_torch.parallel import train_state

    monkeypatch.setattr(train_state, "_adamw_group", lambda *a, **k: None)
    r = run(spec, "train-tiny")
    assert not r["correct"] and r["checks"]["update_med"]["value"] == pytest.approx(1.0)


def test_train_step_on_half_the_batch(spec, monkeypatch):
    """The batch reaches the step with half of its clips left out: the
    loss is the mean over the rest."""
    from univs_tpu_torch.parallel.train_state import TrainBatch

    to = TrainBatch.to

    def half(self, device):
        b = to(self, device)
        n = b.images.shape[0] // 2
        cut = lambda x: x[:n] if x is not None and x.shape[0] == 2 * n else x  # noqa: E731
        targets = type(b.targets)(*(cut(x) for x in (
            b.targets.labels, b.targets.ids, b.targets.masks, b.targets.valid,
            b.targets.prompt_obj_ids, b.targets.sem_labels, b.targets.sem_masks)))
        return TrainBatch(cut(b.images), cut(b.frame_indices), targets, cut(b.prompt_category_embs),
                          cut(b.prompt_category_valid), b.category_bank, b.category_bank_valid)

    monkeypatch.setattr(TrainBatch, "to", half)
    r = run(spec, "train-tiny")
    assert not r["correct"] and r["checks"]["loss_gap"]["value"] > TIGHT["loss_gap"]


@pytest.mark.parametrize("cell,host", [("vis-tiny", {"finish_ms.vis", "clip_loop_ms.vis"}),
                                       ("train-tiny", {"host_jv_ms.train"})])
def test_traced_run(spec, cell, host):
    """A traced run on the CPU: the host-clock readers report, those of the
    device trace find nothing and are left out; the breakdown is there."""
    r = run_cell(spec, cell, SEED, 1.0, True, "cpu", time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == host
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0


def test_cell_and_metric_added_as_files(tmp_path):
    root = make_root(str(tmp_path), "float32", TIGHT)
    b = os.path.join(root, "benchmark")
    mix = json.load(open(os.path.join(b, "traffic", "vss_stream_tiny.json")))
    json.dump(dict(mix, frames=5, classes=3), open(os.path.join(b, "traffic", "dummy_mix.json"), "w"))
    json.dump({k: TIGHT[k] for k in ("logit_ratio", "mask_ratio", "label_gap")},
              open(os.path.join(b, "limits", "dummy-cell.json"), "w"))
    with open(os.path.join(b, "metrics", "dummy_clips.py"), "w") as f:
        f.write('"""dummy_clips: clips done in the window."""\n\n\ndef read(run):\n'
                '    return run.work["clips"]\n')
    d = json.load(open(os.path.join(root, "BENCHMARK.json")))
    d["workloads"].append({"name": "dummy-cell", "config": "tiny", "traffic": "dummy_mix",
                           "chips": 1, "why": "added as files"})
    d["end_to_end"].append({"name": "dummy_clips", "unit": "clips", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["dummy-cell"]})
    json.dump(d, open(os.path.join(root, "BENCHMARK.json"), "w"))
    r = run(Spec(root), "dummy-cell")
    assert r["correct"] and r["metrics"]["dummy_clips"]["value"] >= 1
    assert set(r["metrics"]) == {"dummy_clips", "setup_s"}
