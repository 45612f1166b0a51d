"""Batched serving and two-device pipelining of the port on the CPU:
``BatchedVISServer.run_vis`` on two videos of unequal length against
the JAX package's server (the same entities, byte-identical RLEs,
scores to 1e-4), against the port's ``EntityDriver.run_vis`` (equal
lengths: every video; unequal: the longest, the shorter cut to its
length), one batched window encode per window (the video axis folded
into the frame axis), and ``EntityDriver(pipeline_devices=('cpu',
'cpu'))`` identical to the unpipelined driver.  Tiny config, thresholds
relaxed so entities are admitted, a 4-frame window so the videos span
several windows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_util import seeded_flax_params
from univs_tpu.config import tiny_test_config
from univs_tpu.inference.serving import BatchedVISServer as JaxServer
from univs_tpu.models.univs import UniVSModel
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference.driver import EntityDriver
from univs_tpu_torch.inference.serving import BatchedVISServer
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

H, W, K, E = 64, 96, 5, 6


def _relaxed(cfg):
    inf = dataclasses.replace(
        cfg.inference, num_frames=2, clip_stride=1, num_frames_window=4, apply_cls_thres=0.0,
        consistency_thres=(-1.0, 0.5), topk_per_video=4)
    return dataclasses.replace(cfg, inference=inf,
                               prompt=dataclasses.replace(cfg.prompt, num_prev_frames_memory=3))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _relaxed(tiny_test_config()), _relaxed(torch_tiny_config())
    jm = UniVSModel(jcfg)
    rng = np.random.RandomState(0)
    cls_emb = rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = TextPrompts(embs=jnp.asarray(cls_emb)[None, :, None, :], valid=jnp.ones((1, K), bool))
    params = seeded_flax_params(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, H, W, 3)), jnp.arange(2)[None],
        task="detection", text_prompts=tp, cls_emb=jnp.asarray(cls_emb))["params"], seed=3)
    params = jax.tree.map(np.asarray, params)
    videos = [np.random.RandomState(s).randint(0, 256, (n, H, W, 3)).astype(np.uint8)
              for s, n in ((1, 7), (2, 5), (4, 7))]
    return jcfg, tcfg, params, cls_emb, videos


def _same(got, want, V):
    assert [r["obj_id"] for r in got] == [r["obj_id"] for r in want]
    for g, w in zip(got, want):
        assert len(g["segmentations"]) == V
        assert g["segmentations"] == w["segmentations"], g["obj_id"]
        np.testing.assert_allclose(g["score"], np.asarray(w["score"]), rtol=1e-4, atol=1e-6)


def test_batched_server_matches_jax_on_unequal_lengths(setup):
    jcfg, tcfg, params, cls_emb, videos = setup
    pair = [videos[0], videos[1]]
    want = JaxServer(jcfg, params, num_classes=K, capacity=E, batch_size=2).run_vis(
        pair, jnp.asarray(cls_emb))
    srv = BatchedVISServer(tcfg, state_dict_from_flax(params), num_classes=K, capacity=E,
                           batch_size=2, device="cpu")
    got = srv.run_vis(pair, torch.as_tensor(cls_emb))
    assert sum(len(w) for w in want) >= 1, "relaxed thresholds must admit entities"
    for b, v in enumerate(pair):
        _same(got[b], want[b], v.shape[0])


def test_batched_server_matches_entity_driver(setup, monkeypatch):
    _, tcfg, params, cls_emb, videos = setup
    sd = state_dict_from_flax(params)
    srv = BatchedVISServer(tcfg, sd, num_classes=K, capacity=E, batch_size=2, device="cpu")
    single = EntityDriver(tcfg, srv.model, num_classes=K, capacity=E, device="cpu")
    emb = torch.as_tensor(cls_emb)
    calls = []
    encode = srv.driver.encode_window
    monkeypatch.setattr(srv.driver, "encode_window",
                        lambda f, *videos: calls.append(f.shape[0]) or encode(f, *videos))
    equal = srv.run_vis([videos[0], videos[2]], emb)
    V = videos[0].shape[0]
    assert calls == [2 * tcfg.inference.num_frames_window] * srv.num_window_encodes(V)
    assert len(calls) > 1
    for b, v in enumerate((videos[0], videos[2])):
        _same(equal[b], single.run_vis(v, emb), V)
    mixed = srv.run_vis([videos[0], videos[1]], emb)
    _same(mixed[0], single.run_vis(videos[0], emb), V)
    assert all(len(r["segmentations"]) == videos[1].shape[0] for r in mixed[1])
    assert sum(len(m) for m in equal) >= 1


def test_pipeline_devices_same_as_unpipelined(setup):
    _, tcfg, params, cls_emb, videos = setup
    sd = state_dict_from_flax(params)
    plain = EntityDriver(tcfg, sd, num_classes=K, capacity=E, device="cpu")
    piped = EntityDriver(tcfg, sd, num_classes=K, capacity=E, pipeline_devices=("cpu", "cpu"))
    emb = torch.as_tensor(cls_emb)
    assert piped.device == torch.device("cpu") and piped._enc_model is not None
    want = plain.run_vis(videos[0], emb)
    assert len(want) >= 1
    _same(piped.run_vis(videos[0], emb), want, videos[0].shape[0])


def test_server_refuses_a_wrong_batch(setup):
    _, tcfg, params, cls_emb, videos = setup
    srv = BatchedVISServer(tcfg, state_dict_from_flax(params), num_classes=K, capacity=E,
                           batch_size=2, device="cpu")
    with pytest.raises(ValueError):
        srv.run_vis([videos[0]], torch.as_tensor(cls_emb))
    with pytest.raises(ValueError):
        srv.run_vis([videos[0], videos[0][:, :32]], torch.as_tensor(cls_emb))
