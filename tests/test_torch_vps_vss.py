"""End-to-end parity of the port's VPS and VSS drivers against the JAX
package's on the CPU, on the tiny config (64x96 frames, T=2, stride 1, a
6-frame window so the video spans several windows and emissions;
thresholds relaxed so entities are admitted): ``EntityDriver.run_vps``
must give the same panoptic maps and ``segments_info``, and
``run_vss`` the same label maps, both with a crop to the image size and
a resize to another output size (the engine's ``image_size`` /
``out_size``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import tiny_test_config
from univs_tpu.inference.driver import EntityDriver as JaxEntityDriver
from univs_tpu.models.univs import UniVSModel
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference.driver import EntityDriver
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

V, H, W, K, E = 7, 64, 96, 5, 6
IMAGE, OUT = (60, 90), (30, 45)
THINGS = (1, 3)  # 1-based thing classes


def _relaxed(cfg):
    inf = dataclasses.replace(
        cfg.inference, num_frames=2, clip_stride=1, num_frames_window=6, apply_cls_thres=0.0,
        consistency_thres=(-1.0, 0.5), topk_per_video=4)
    prompt = dataclasses.replace(cfg.prompt, num_prev_frames_memory=3)
    return dataclasses.replace(cfg, inference=inf, prompt=prompt)


@pytest.fixture(scope="module")
def drivers():
    jcfg = _relaxed(tiny_test_config())
    tcfg = _relaxed(torch_tiny_config())
    jm = UniVSModel(jcfg)
    rng = np.random.RandomState(0)
    cls_emb = rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = TextPrompts(embs=jnp.asarray(cls_emb)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                             text_prompts=tp, cls_emb=jnp.asarray(cls_emb)))
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)), jnp.arange(2)[None])["params"]
    params = jax.tree.map(np.asarray, params)
    jd = JaxEntityDriver(jcfg, params, num_classes=K, capacity=E, thing_class_ids=THINGS)
    td = EntityDriver(tcfg, state_dict_from_flax(params), num_classes=K, capacity=E,
                      device="cpu", thing_class_ids=THINGS)  # run_vps's default
    video = np.random.RandomState(1).randint(0, 256, (V, H, W, 3)).astype(np.uint8)
    return jd, td, cls_emb, video


@pytest.fixture(scope="module")
def jax_vps(drivers):
    jd, _, cls_emb, video = drivers
    return jd.run_vps(video, jnp.asarray(cls_emb), THINGS, IMAGE, OUT)


@pytest.mark.parametrize("things_from", ["argument", "constructor"])
def test_run_vps_same_panoptic(drivers, jax_vps, things_from):
    """The thing classes given to ``run_vps`` or, by default, to the
    driver's constructor."""
    _, td, cls_emb, video = drivers
    want_pan, want_info = jax_vps
    things = THINGS if things_from == "argument" else None
    got_pan, got_info = td.run_vps(video, torch.as_tensor(cls_emb), things, IMAGE, OUT)
    assert len(want_info) >= 1, "relaxed thresholds must register segments"
    assert got_pan.dtype == np.int32 and got_pan.shape == (V, *OUT)
    np.testing.assert_array_equal(got_pan, want_pan)
    assert got_info == want_info


def test_run_vss_same_labels(drivers):
    """V=7 at T=2: three full clips and a short tail clip of one frame."""
    jd, td, cls_emb, video = drivers
    want = jd.run_vss(video, jnp.asarray(cls_emb), IMAGE, OUT)
    with torch.no_grad():
        got = td.run_vss(video, torch.as_tensor(cls_emb), IMAGE, OUT)
    assert got.dtype == np.int32 and got.shape == (V, *OUT)
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)
