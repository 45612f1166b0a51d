"""The port's engine against the JAX package's on the CPU, for the
category-guided tasks: ``_eval_ytvis`` (also pipelined over two CPU
devices), ``_eval_vss``, ``_eval_vps``, ``_eval_image`` (panoptic and
instance datasets), ``_predict_only``, and ``evaluate_dataset`` by name
on a synthetic ytvis tree.  Both run the tiny config on the same weights
(``state_dict_from_flax``): every metric equal (fps excluded), the
submission trees byte-identical, the prediction files equal but for the
float32 scores' last bits."""

import copy
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from univs_tpu import engine as jax_engine
from univs_tpu_torch import engine
from torch_engine_util import (JAX_MAPPER, MAPPER, assert_same_metrics, assert_same_outputs,
                               assert_same_predictions, setup, toy_records)

torch.set_num_threads(1)

# 1-based thing classes of the 5-class panoptic toy datasets (both toy
# objects things for VPS, so tracks are scored; one for the image)
VPS_THINGS, THINGS = {1, 2}, {1, 3}


@pytest.fixture(scope="module")
def ctx():
    return setup()


@pytest.fixture(scope="module")
def ytvis_records(ctx):
    """Toy records whose ground truth adds the port's first entity under its
    best class (from a run of the driver), so AP is neither 0 nor 1."""
    _, tcfg, _, sd, bank = ctx
    recs = toy_records()
    driver = engine.EntityDriver(tcfg, sd, num_classes=bank.shape[0], capacity=6, device="cpu")
    s = MAPPER(recs[0])
    ents = driver.run_vis(s["images"], torch.as_tensor(bank), s["image_size"], s["out_size"])
    assert len(ents) >= 1, "relaxed gates must admit entities"
    recs[0]["annotations"].append({
        "id": 10, "category_id": int(np.argmax(ents[0]["score"])) + 1, "iscrowd": 0,
        "segmentations": ents[0]["segmentations"]})
    return recs


def test_eval_ytvis_equals_jax(ctx, ytvis_records, tmp_path):
    jcfg, tcfg, params, sd, bank = ctx
    want = jax_engine._eval_ytvis(jcfg, params, ytvis_records, JAX_MAPPER, bank,
                                  str(tmp_path / "jax"))
    got = engine._eval_ytvis(tcfg, sd, ytvis_records, MAPPER, bank, str(tmp_path / "port"),
                             device="cpu")
    assert 0.0 < want["AP"] < 1.0
    assert_same_metrics(got, want)
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", results=("results.json",))
    assert len(json.loads((tmp_path / "jax" / "results.json").read_text())) >= 2


def test_eval_ytvis_pipelined_equals_single_device(ctx, ytvis_records):
    _, tcfg, _, sd, bank = ctx
    single = engine._eval_ytvis(tcfg, sd, ytvis_records, MAPPER, bank, None, device="cpu")
    piped = engine._eval_ytvis(tcfg, sd, ytvis_records, MAPPER, bank, None,
                               pipeline_devices=("cpu", "cpu"))
    assert_same_metrics(piped, single)


def test_eval_vss_equals_jax(ctx):
    jcfg, tcfg, params, sd, bank = ctx
    recs = toy_records(length=9)  # video consistency over a window of 8
    want = jax_engine._eval_vss(jcfg, params, recs, JAX_MAPPER, bank)
    got = engine._eval_vss(tcfg, sd, recs, MAPPER, bank, device="cpu")
    assert np.isfinite(want["mIoU"]) and np.isfinite(want["mVC"])
    assert_same_metrics(got, want)


def test_eval_vps_equals_jax(ctx, tmp_path):
    jcfg, tcfg, params, sd, bank = ctx
    recs = toy_records()
    want = jax_engine._eval_vps(jcfg, params, recs, JAX_MAPPER, bank, VPS_THINGS,
                                output_dir=str(tmp_path / "jax"))
    got = engine._eval_vps(tcfg, sd, recs, MAPPER, bank, VPS_THINGS,
                           output_dir=str(tmp_path / "port"), device="cpu")
    assert want["VPQ"] > 0 and want["STQ"] > 0
    assert_same_metrics(got, want)
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "jax" / "pred.json").is_file()


@pytest.mark.parametrize("things", [THINGS, set()], ids=["panoptic", "instance"])
def test_eval_image_equals_jax(ctx, things, tmp_path):
    jcfg, tcfg, params, sd, bank = ctx
    recs = toy_records(length=1, video_id=11)
    want = jax_engine._eval_image(jcfg, params, recs, JAX_MAPPER, bank, things,
                                  output_dir=str(tmp_path / "jax"))
    got = engine._eval_image(tcfg, sd, recs, MAPPER, bank, things,
                             output_dir=str(tmp_path / "port"), device="cpu")
    assert ("PQ" in want) == bool(things)
    assert_same_metrics(got, want)
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", results=("image_results.json",))
    assert json.loads((tmp_path / "jax" / "image_results.json").read_text())


def test_predict_only_equals_jax(ctx, tmp_path):
    jcfg, tcfg, params, sd, bank = ctx
    det = toy_records()[0]
    det["annotations"] = []
    gnd = copy.deepcopy(det)
    gnd.update(video_id=2, video_name="vid2", task="grounding",
               expressions=["the box", "the other box"])
    want = jax_engine._predict_only(jcfg, params, [det, gnd], JAX_MAPPER, bank,
                                    output_dir=str(tmp_path / "jax"))
    got = engine._predict_only(tcfg, sd, [det, gnd], MAPPER, bank,
                               output_dir=str(tmp_path / "port"), device="cpu")
    assert want["num_predictions"] >= 1
    assert_same_metrics(got, want)
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", results=("results.json",))
    assert any(p.startswith(os.path.join("inference", "Annotations", "vid2", "1"))
               for p in map(str, (q.relative_to(tmp_path / "port")
                                  for q in (tmp_path / "port").rglob("*.png"))))


def test_evaluate_dataset_by_name_equals_jax(ctx, ytvis_records, tmp_path, monkeypatch):
    """``evaluate_dataset("ytvis_2019_val")`` over a tree written under
    ``UNIVS_TPU_DATA_ROOT``: JSON, PNG frames, the registry's paths."""
    jcfg, tcfg, params, sd, bank = ctx
    from univs_tpu_torch.data.datasets import get_spec

    spec = get_spec("ytvis_2019_val")
    rec = ytvis_records[0]
    rng = np.random.RandomState(rec["video_id"])
    names = []
    for t in range(rec["length"]):
        name = f"video1/{t:05d}.png"
        os.makedirs(tmp_path / spec.image_root / "video1", exist_ok=True)
        Image.fromarray((rng.rand(rec["height"], rec["width"], 3) * 255).astype(np.uint8)).save(
            tmp_path / spec.image_root / name)
        names.append(name)
    anns = [dict(a, video_id=1, category_id=a["category_id"] + 1) for a in rec["annotations"]]
    data = {"videos": [{"id": 1, "file_names": names, "height": rec["height"],
                        "width": rec["width"], "length": rec["length"]}],
            "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in range(2, 2 + bank.shape[0])]}
    os.makedirs(os.path.dirname(tmp_path / spec.json_path), exist_ok=True)
    (tmp_path / spec.json_path).write_text(json.dumps(data))
    monkeypatch.setenv("UNIVS_TPU_DATA_ROOT", str(tmp_path))
    want = jax_engine.evaluate_dataset(jcfg, params, "ytvis_2019_val", bank,
                                       output_dir=str(tmp_path / "out_jax"))
    got = engine.evaluate_dataset(tcfg, sd, "ytvis_2019_val", bank,
                                  output_dir=str(tmp_path / "out_port"), device="cpu")
    assert 0.0 < want["AP"]
    assert_same_metrics(got, want)
    assert_same_predictions(json.loads((tmp_path / "out_port" / "results.json").read_text()),
                            json.loads((tmp_path / "out_jax" / "results.json").read_text()))
