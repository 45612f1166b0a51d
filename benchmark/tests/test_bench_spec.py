"""BENCHMARK.json and the files it names: lookup by name and the
contract's shape."""

import json
import os
import re

import pytest

from benchmark.harness import configs
from benchmark.harness.spec import Spec
from benchmark.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim|_rank|head|expansion|"
                   r"experts_per_tok|mlp_ratio|embed)")


@pytest.fixture(scope="module")
def spec():
    return Spec(ROOT)


def test_cells_configs_mixes_and_readers_found_by_name(spec):
    cell = spec.cell("vis-r50")
    assert (cell.config, cell.traffic, cell.chips) == ("univs-r50", "vis_stream", 1)
    assert spec.config("univs-swinl")["model"]["backbone"]["name"] == "swin_large"
    assert spec.traffic("vss_stream")["kind"] == "vss_stream"
    assert set(spec.limits("vss-swinl")) == {"logit_ratio", "mask_ratio", "label_gap"}
    assert set(spec.limits("train-swinl")) == {"loss_gap", "grad_gap", "grad_dist", "update_med"}
    assert set(spec.limits("vis-r50")) == {
        "logit_ratio", "mask_ratio", "embd_ratio", "proca_ratio", "start_diff", "step_diff",
        "drain_diff"}
    assert callable(spec.reader("mfu.vss"))
    for kind in ("vis_stream", "vss_stream", "train_step"):
        loop = spec.loop(kind)
        assert loop.chips == (1,) and "fp8" in loop.controls
    assert [m.name for m in spec.metrics("vis-r50", "end_to_end")] == ["vis_fps", "setup_s"]
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_contract_shape(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= d["run_seconds"] <= 51 and d["paths"] == ["benchmark"]
    runs = 2 + 14 * 24
    assert runs * (d["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    cells = {w["name"]: w for w in d["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in d["end_to_end"]}["setup_s"] <= 0.25
    e2e = {m["name"]: m for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    for w in cells:
        assert {m.name for m in spec.metrics(w, "end_to_end")} > {"setup_s"}
        assert spec.metrics(w, "per_layer")
        assert os.path.exists(os.path.join(BENCH, "limits", w + ".json"))
        assert os.path.exists(os.path.join(BENCH, "traffic", cells[w]["traffic"] + ".json"))
    assert len(json.dumps(d)) < 64 * 1024


def test_configurations_state_every_size_in_both_trees(spec):
    for c in spec.data["configs"]:
        assert c["file"].startswith("benchmark/") and not any(WIDTH.search(k) for k in c["reduced"])
        tree = spec.config(c["name"])["model"]
        pc, rc = configs.program_config(tree), configs.reference_config(tree)
        assert pc.backbone.name == rc.backbone.name == tree["backbone"]["name"]
        assert pc.decoder == configs.program_config(tree).decoder
    with pytest.raises(KeyError):
        configs.program_config({"decoder": {"no_such_size": 1}})
