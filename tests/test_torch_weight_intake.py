"""Weight intake end to end on the CPU: one tiny reference-named UniVS
``.pth`` (the student from the port's seeded init, seed 0, with the
historical ``static_query``; the EMA teacher, seed 1, under ``teacher.``)
loaded into the port's model through the port's ``load_params`` and into
the JAX model through JAX's.  The pixel decoder's outputs (after the
backbone) and the decoder's within 1e-4 of their largest magnitude, and
``EntityDriver.run_vis`` returns the same entities with byte-identical
RLEs (relaxed gates, so entities are admitted)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_convert_util import save_reference, univs_reference, with_teacher
from univs_tpu.config import tiny_test_config as jax_tiny_config
from univs_tpu.inference.driver import EntityDriver as JaxEntityDriver
from univs_tpu.models.univs import build_decoder as jax_build_decoder
from univs_tpu.utils.checkpoint import load_params as jax_load_params
from univs_tpu_torch.config import tiny_test_config
from univs_tpu_torch.inference.driver import EntityDriver
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(1)

V, H, W, K, E, WINDOW = 8, 64, 96, 5, 6, 6


def _relaxed(cfg):
    inf = dataclasses.replace(
        cfg.inference, num_frames=2, clip_stride=1, num_frames_window=WINDOW,
        apply_cls_thres=0.0, consistency_thres=(-1.0, 0.5), topk_per_video=4)
    return dataclasses.replace(cfg, inference=inf, prompt=dataclasses.replace(
        cfg.prompt, num_prev_frames_memory=3))


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    tcfg, jcfg = _relaxed(tiny_test_config()), _relaxed(jax_tiny_config())
    student = build_model(tcfg, None, seed=0, device="cpu").state_dict()
    teacher = build_model(tcfg, None, seed=1, device="cpu").state_dict()
    path = str(tmp_path_factory.mktemp("intake") / "univs_tiny_ema.pth")
    save_reference(path, with_teacher(univs_reference(student), univs_reference(teacher)))
    td = EntityDriver(tcfg, load_params(path, tcfg), num_classes=K, capacity=E, device="cpu")
    jparams = jax_load_params(path)
    jd = JaxEntityDriver(jcfg, jparams, num_classes=K, capacity=E)
    rng = np.random.RandomState(0)
    cls_emb = rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
    video = rng.randint(0, 256, (V, H, W, 3)).astype(np.uint8)
    return dict(td=td, jd=jd, jcfg=jcfg, jparams=jparams, teacher=teacher, cls_emb=cls_emb,
                video=video)


def test_the_teacher_is_loaded(loaded):
    got = loaded["td"].model.state_dict()
    assert sorted(got) == sorted(loaded["teacher"])
    for k, v in loaded["teacher"].items():
        assert torch.equal(got[k], v), k


def test_pixel_decoder_and_decoder_activations_equal_jax(loaded):
    td, jd, frames = loaded["td"], loaded["jd"], loaded["video"][:WINDOW]
    want_mf, want_ms = jd._encode_window_fn(jd.params, jnp.asarray(frames))
    with torch.no_grad():
        mf, ms = td.encode_window(torch.as_tensor(frames))
    _close(mf.numpy(), want_mf)
    assert len(ms) == len(want_ms) == 3
    for g, w in zip(ms, want_ms):
        _close(g.numpy(), w)
    # the decoder on the first clip's features
    T, cls_emb = 2, loaded["cls_emb"]
    fi = np.arange(T)[None]
    want = jax.jit(lambda p, ms, mf, fi, ce: jax_build_decoder(loaded["jcfg"]).apply(
        {"params": p}, ms, mf, fi, task="detection", cls_emb=ce))(
        loaded["jparams"]["decoder"], [m[:T] for m in want_ms], want_mf[:T], jnp.asarray(fi),
        jnp.asarray(cls_emb))
    with torch.no_grad():
        got = td.model.decoder([m[:T] for m in ms], mf[:T], torch.as_tensor(fi),
                               task="detection", cls_emb=torch.as_tensor(cls_emb))
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        _close(got[k].numpy(), want[k])


def test_run_vis_rles_byte_identical(loaded):
    td, jd, cls_emb = loaded["td"], loaded["jd"], loaded["cls_emb"]
    want = jd.run_vis(loaded["video"], jnp.asarray(cls_emb))
    with torch.no_grad():
        got = td.run_vis(loaded["video"], torch.as_tensor(cls_emb))
    assert len(want) >= 1, "relaxed gates must admit entities"
    assert [r["obj_id"] for r in got] == [r["obj_id"] for r in want]
    for g, w in zip(got, want):
        assert g["segmentations"] == w["segmentations"], g["obj_id"]
        np.testing.assert_allclose(g["score"], np.asarray(w["score"]), rtol=1e-4, atol=1e-6)
