"""The port's engine against the JAX package's on the CPU, for the
prompt-guided tasks: ``_eval_vos`` (DAVIS J&F and its codalab tree),
``_eval_vos(pvos=True)`` (the VIPOSeg G buckets, and the warning on class
ids outside its tables), ``_eval_refvos`` with JAX's random prompts and
with a text tower; and the one model that the per-video ``VOSDriver``s
share.  Every metric equal (fps excluded), the trees byte-identical.

VOS label maps rest on float32 logits that random weights leave at ~0
(``logit.amax <= 0`` is background), so the two packages may label a
pixel differently where its logit is a tie at 0 (the port reads
2.5e-9..3e-8 at the six pixels of one frame where they differ here).  The
VOS cases therefore hold the drivers' label maps equal outside such ties,
and then feed the JAX engine the port's label maps, so that everything
the engine does after the driver (ground truth, buckets, metrics, trees)
is compared exactly."""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu import engine as jax_engine
from univs_tpu.inference import driver as jax_driver
from univs_tpu.models.clip_text import ClipTextEncoder as JaxClipTextEncoder
from univs_tpu.models.clip_text import TextPromptEncoder as JaxTextPromptEncoder
from univs_tpu.models.tokenizer import ClipTokenizer as JaxClipTokenizer
from univs_tpu_torch import engine
from univs_tpu_torch.inference import driver
from univs_tpu_torch.models.clip_text import ClipTextEncoder, TextPromptEncoder
from univs_tpu_torch.models.tokenizer import ClipTokenizer
from univs_tpu_torch.utils.weights import state_dict_from_flax
from torch_engine_util import (JAX_MAPPER, MAPPER, assert_same_metrics, assert_same_outputs,
                               recording, replaying, setup, toy_records)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    return setup()


def _two_videos(task):
    a = toy_records(task=task, length=5)
    b = toy_records(task=task, length=4, video_id=2)
    b[0]["annotations"] = b[0]["annotations"][::-1]  # object order and first frames differ
    return a + b


TIE = 1e-6


@contextlib.contextmanager
def label_ties(ties: list):
    """Per frame the port's ``VOSDriver.run`` labels, the pixels whose label
    rests on a tie: the largest logit within ``TIE`` of 0 or of the
    runner-up."""
    fn = driver._upsample_logits_device

    def wrapped(*args, **kwargs):
        logit = fn(*args, **kwargs)
        top = torch.topk(logit, min(2, logit.shape[0]), dim=0).values
        tie = top[0].abs() < TIE
        if top.shape[0] > 1:
            tie |= (top[0] - top[1]) < TIE
        ties.append(tie.numpy())
        return logit

    driver._upsample_logits_device = wrapped
    try:
        yield ties
    finally:
        driver._upsample_logits_device = fn


def _vos_against_jax(ctx, tmp_path, **kw):
    """(port metrics, JAX metrics on the port's label maps): the drivers'
    label maps held equal outside ties first."""
    jcfg, tcfg, params, sd, bank = ctx
    recs = _two_videos("sot")
    with recording(driver.VOSDriver, "run", []) as port_maps, label_ties([]) as ties:
        got = engine._eval_vos(tcfg, sd, recs, MAPPER, bank, output_dir=str(tmp_path / "port"),
                               device="cpu", **kw)
    with recording(jax_driver.VOSDriver, "run", []) as jax_maps:
        jax_engine._eval_vos(jcfg, params, recs, JAX_MAPPER, bank, **kw)
    frames = [f for m in port_maps for f in m]
    assert len(frames) == len(ties) == sum(r["length"] for r in recs)
    jax_frames = [f for m in jax_maps for f in m]
    for p, j, tie in zip(frames, jax_frames, ties):
        assert p.shape == j.shape and not ((p != j) & ~tie).any()
    with replaying(jax_driver.VOSDriver, "run", port_maps):
        want = jax_engine._eval_vos(jcfg, params, recs, JAX_MAPPER, bank,
                                    output_dir=str(tmp_path / "jax"), **kw)
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    return got, want


def test_eval_vos_equals_jax(ctx, tmp_path):
    got, want = _vos_against_jax(ctx, tmp_path)
    assert 0.0 < want["J"] < 1.0
    assert_same_metrics(got, want)
    assert len(list((tmp_path / "jax").rglob("*.png"))) == 9


def test_eval_pvos_equals_jax(ctx, tmp_path):
    got, want = _vos_against_jax(ctx, tmp_path, pvos=True)
    # raw ids 61 and 29 are VIPOSeg's thing 60 and stuff 28, both seen
    assert np.isfinite(want["thing_seen_iou"]) and np.isfinite(want["stuff_seen_iou"])
    assert np.isnan(want["overall_iou"])  # no unseen bucket: JAX's NaN
    assert_same_metrics(got, want)


def test_eval_pvos_warns_on_ids_outside_the_tables(ctx):
    jcfg, tcfg, params, sd, bank = ctx
    recs = toy_records(task="sot")
    recs[0]["annotations"][1]["raw_category_id"] = 500
    with pytest.warns(UserWarning, match="not in the VIPOSeg"):
        with recording(driver.VOSDriver, "run", []) as port_maps:
            got = engine._eval_vos(tcfg, sd, recs, MAPPER, bank, pvos=True, device="cpu")
    with pytest.warns(UserWarning, match="not in the VIPOSeg"):
        with replaying(jax_driver.VOSDriver, "run", port_maps):
            want = jax_engine._eval_vos(jcfg, params, recs, JAX_MAPPER, bank, pvos=True)
    assert np.isnan(want["stuff_seen_iou"])
    assert_same_metrics(got, want)


def _grounding_records():
    recs = _two_videos("grounding")
    recs[0].update(expressions=["the box", "the other box", "nothing"], exp_obj_ids=[1, 2, 9],
                   exp_ids=["0", "1", "2"])
    recs[1].update(expressions=["a box"], exp_obj_ids=[2])
    return recs


def test_eval_refvos_random_prompts_equal_jax(ctx, tmp_path):
    jcfg, tcfg, params, sd, bank = ctx
    recs = _grounding_records()
    want = jax_engine._eval_refvos(jcfg, params, recs, JAX_MAPPER, bank,
                                   output_dir=str(tmp_path / "jax"))
    got = engine._eval_refvos(tcfg, sd, recs, MAPPER, bank, output_dir=str(tmp_path / "port"),
                              device="cpu")
    assert 0.0 < want["J"] < 1.0
    assert_same_metrics(got, want)
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "jax").rglob("*.png"))) == 3 * 5 + 1 * 4


def test_eval_refvos_with_a_text_tower_equals_jax(ctx):
    jcfg, tcfg, params, sd, bank = ctx
    small = dict(embed_dim=bank.shape[1], width=16, heads=2, num_layers=1)
    tower = JaxClipTextEncoder(**small)
    variables = jax.tree.map(np.asarray, tower.init(jax.random.PRNGKey(3),
                                                    jnp.zeros((1, 77), jnp.int32)))
    jenc = JaxTextPromptEncoder(variables, tower, JaxClipTokenizer())
    tenc = TextPromptEncoder(state_dict_from_flax(variables["params"]), ClipTextEncoder(**small),
                             ClipTokenizer(), device="cpu")
    recs = _grounding_records()[:1]
    want = jax_engine._eval_refvos(jcfg, params, recs, JAX_MAPPER, bank, text_encoder=jenc)
    got = engine._eval_refvos(tcfg, sd, recs, MAPPER, bank, text_encoder=tenc, device="cpu")
    assert_same_metrics(got, want)


def test_per_video_drivers_share_one_model(ctx, monkeypatch):
    """``_eval_vos`` builds one model for all its videos; a built model is
    taken as it is; the metrics do not change."""
    _, tcfg, _, sd, bank = ctx
    recs = _two_videos("sot")
    builds = []
    build = engine.build_model
    monkeypatch.setattr(engine, "build_model", lambda *a, **k: builds.append(1) or build(*a, **k))
    want = engine._eval_vos(tcfg, sd, recs, MAPPER, bank, device="cpu")
    assert len(builds) == 1
    model = build(tcfg, sd, device="cpu")
    got = engine._eval_vos(tcfg, model, copy.deepcopy(recs), MAPPER, bank, device="cpu")
    assert len(builds) == 1
    assert_same_metrics(got, want)
