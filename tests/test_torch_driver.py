"""End-to-end parity of the PyTorch port's VIS driver against the JAX
package's on the CPU: ``EntityDriver.run_vis`` on the tiny config
(64x96 frames, T=2, stride 1, a 6-frame window so the video spans
several windows and emissions; thresholds relaxed so entities are
admitted) must return the same entities with byte-identical RLEs, and
two different videos streamed through ``start_vis(next_frames=...)`` /
``finish_vis`` must match too.  Scores to 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import tiny_test_config
from univs_tpu.inference.driver import EntityDriver as JaxEntityDriver
from univs_tpu.inference.driver import vis_results_to_ytvis_json as jax_ytvis_json
from univs_tpu.models.univs import UniVSModel
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference.driver import EntityDriver, vis_results_to_ytvis_json
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

V, H, W, K, E = 8, 64, 96, 5, 6


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
    jd = JaxEntityDriver(jcfg, params, num_classes=K, capacity=E)
    td = EntityDriver(tcfg, state_dict_from_flax(params), num_classes=K, capacity=E, device="cpu")
    videos = [np.random.RandomState(s).randint(0, 256, (V, H, W, 3)).astype(np.uint8)
              for s in (1, 2)]
    return jd, td, cls_emb, videos


def _same_results(got, want):
    assert [r["obj_id"] for r in got] == [r["obj_id"] for r in want]
    for g, w in zip(got, want):
        assert len(g["segmentations"]) == V
        assert g["segmentations"] == w["segmentations"], g["obj_id"]
        np.testing.assert_allclose(g["score_windows"], np.asarray(w["score_windows"]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g["score"], np.asarray(w["score"]), rtol=1e-4, atol=1e-6)
        assert abs(g["mask_quality_score"] - w["mask_quality_score"]) <= 1e-4


def test_run_vis_same_rles(drivers):
    jd, td, cls_emb, videos = drivers
    want = jd.run_vis(videos[0], jnp.asarray(cls_emb))
    with torch.no_grad():
        got = td.run_vis(videos[0], torch.as_tensor(cls_emb))
    assert len(want) >= 1, "relaxed thresholds must admit entities"
    _same_results(got, want)
    # YTVIS records: the same (entity, class) records, scores to 1e-4
    got_json = vis_results_to_ytvis_json(7, V, H, W, got, apply_cls_thresh=0.0, topk_per_video=3)
    want_json = jax_ytvis_json(7, V, H, W, want, apply_cls_thresh=0.0, topk_per_video=3)
    assert len(got_json) == len(want_json) >= 1
    for g, w in zip(got_json, want_json):
        assert (g["category_id"], g["segmentations"]) == (w["category_id"], w["segmentations"])
        assert abs(g["score"] - w["score"]) <= 1e-4 * max(abs(w["score"]), 1e-6)


def test_start_finish_two_videos(drivers):
    jd, td, cls_emb, videos = drivers
    jh = jd.start_vis(videos[0], jnp.asarray(cls_emb), next_frames=videos[1])
    jh2 = jd.start_vis(jh["next_frames_device"], jnp.asarray(cls_emb))
    want = [jd.finish_vis(jh), jd.finish_vis(jh2)]
    th = td.start_vis(videos[0], torch.as_tensor(cls_emb), next_frames=videos[1])
    th2 = td.start_vis(th["next_frames_device"], torch.as_tensor(cls_emb))
    got = [td.finish_vis(th), td.finish_vis(th2)]
    for g, w in zip(got, want):
        assert len(w) >= 1
        _same_results(g, w)
