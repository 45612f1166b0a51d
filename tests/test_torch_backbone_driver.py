"""End-to-end parity of the port's VIS driver over the Swin and PVTv2
backbones against the JAX package's on the CPU: ``EntityDriver.run_vis``
on the tiny config (64x96 frames, T=2, stride 1, a 6-frame window; the
gates opened as ``tests/test_torch_driver.py`` opens them) with the
backbone named in the config, the same weights through the weight
bridge, must return the same entities with byte-identical RLEs and
scores within 1e-4.  The Swin case registers a small Swin geometry
under its own name in both packages' ``VARIANTS`` (window 7: every stage
map of a 64x96 frame needs padding, 16x24 -> 21x28 ... 2x3 -> 7x7); the
PVT case is ``pvt_v2_b0`` with the linear SRA, as built by the
backbone factory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import BackboneConfig as JaxBackboneConfig
from univs_tpu.config import tiny_test_config
from univs_tpu.inference.driver import EntityDriver as JaxEntityDriver
from univs_tpu.models.backbones import swin as jswin
from univs_tpu.models.univs import UniVSModel
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import BackboneConfig
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference.driver import EntityDriver
from univs_tpu_torch.models.backbones import swin as tswin
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

V, H, W, K, E = 8, 64, 96, 5, 6
SWIN_TEST = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4))


def _relaxed(cfg, backbone):
    inf = dataclasses.replace(
        cfg.inference, num_frames=2, clip_stride=1, num_frames_window=6, apply_cls_thres=0.0,
        consistency_thres=(-1.0, 0.5), topk_per_video=4)
    prompt = dataclasses.replace(cfg.prompt, num_prev_frames_memory=3)
    return dataclasses.replace(cfg, inference=inf, prompt=prompt, backbone=backbone)


@pytest.fixture(scope="module", params=["swin_test", "pvt_v2_b0"])
def drivers(request):
    name = request.param
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(jswin.VARIANTS, "swin_test", SWIN_TEST)
        patch.setitem(tswin.VARIANTS, "swin_test", SWIN_TEST)
        jcfg = _relaxed(tiny_test_config(), JaxBackboneConfig(name=name))
        tcfg = _relaxed(torch_tiny_config(), BackboneConfig(name=name))
        jm = UniVSModel(jcfg)
        rng = np.random.RandomState(0)
        cls_emb = rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
        tp = TextPrompts(embs=jnp.asarray(cls_emb)[None, :, None, :], valid=jnp.ones((1, K), bool))
        init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                                 text_prompts=tp, cls_emb=jnp.asarray(cls_emb)))
        params = init(jax.random.PRNGKey(1), jnp.zeros((1, 2, H, W, 3)), jnp.arange(2)[None])
        params = jax.tree.map(np.asarray, params["params"])
        jd = JaxEntityDriver(jcfg, params, num_classes=K, capacity=E)
        td = EntityDriver(tcfg, state_dict_from_flax(params), num_classes=K, capacity=E,
                          device="cpu")
        video = np.random.RandomState(2).randint(0, 256, (V, H, W, 3)).astype(np.uint8)
        yield name, jd, td, cls_emb, video


def test_run_vis_over_backbone_same_rles(drivers):
    name, jd, td, cls_emb, video = drivers
    assert type(td.model.backbone).__name__ == ("SwinTransformer" if name.startswith("swin")
                                                else "PVTv2")
    want = jd.run_vis(video, jnp.asarray(cls_emb))
    with torch.no_grad():
        got = td.run_vis(video, torch.as_tensor(cls_emb))
    assert len(want) >= 1, "relaxed thresholds must admit entities"
    assert [r["obj_id"] for r in got] == [r["obj_id"] for r in want]
    for g, w in zip(got, want):
        assert len(g["segmentations"]) == V
        assert g["segmentations"] == w["segmentations"], g["obj_id"]
        np.testing.assert_allclose(g["score"], np.asarray(w["score"]), rtol=1e-4, atol=1e-6)
        assert abs(g["mask_quality_score"] - w["mask_quality_score"]) <= 1e-4
