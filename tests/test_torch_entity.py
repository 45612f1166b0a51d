"""Entity-path parity of the PyTorch port against the JAX package on the
CPU: the exact Hungarian (random and tied cost matrices), the
quasi-track candidate matching, and two ``entity_clip_step`` calls on
the tiny model with the relaxed thresholds of
tests/test_entity_inference.py.  Decisions (valid slots, first
appearances, cand2slot) must match exactly; float pool fields to 1e-4
relative to each field's largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import tiny_test_config
from univs_tpu.inference import memory_pool as jmp
from univs_tpu.inference.entity import EntityClipConfig as JaxClipConfig
from univs_tpu.inference.entity import entity_clip_step as jax_clip_step
from univs_tpu.losses.hungarian import hungarian as jax_hungarian
from univs_tpu.models.univs import UniVSModel, build_decoder, build_pixel_decoder
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference import memory_pool as tmp
from univs_tpu_torch.inference.entity import EntityClipConfig, entity_clip_step
from univs_tpu_torch.losses.hungarian import hungarian
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

T, H, W, K = 2, 64, 96, 5
E, R = 6, 8


@pytest.mark.parametrize("kind", ["random", "tied", "wide_invalid_rows", "all_invalid_rows"])
def test_hungarian_matches_jax(kind):
    rng = np.random.RandomState(
        {"random": 0, "tied": 1, "wide_invalid_rows": 2, "all_invalid_rows": 3}[kind])
    for trial in range(6):
        n, m = (7, 11) if kind in ("random", "tied") else (9, 25)
        cost = rng.rand(n, m).astype(np.float32)
        if kind == "tied":
            cost = np.round(cost * 3) / 3  # few distinct values: many ties
            cost[:, : m // 2] = 1.0
        row_valid = None
        if kind == "wide_invalid_rows":
            row_valid = rng.rand(n) > 0.3
        if kind == "all_invalid_rows":  # an empty pool: the walk is skipped
            row_valid = np.zeros(n, bool)
        want = np.asarray(jax_hungarian(jnp.asarray(cost),
                                        None if row_valid is None else jnp.asarray(row_valid)))
        got = hungarian(torch.as_tensor(cost),
                        None if row_valid is None else torch.as_tensor(row_valid)).numpy()
        np.testing.assert_array_equal(got, want)


def _pools_equal(tp, jp, rel=1e-4):
    for f in dataclasses.fields(tp):
        if f.name == "window_start":
            assert tp.window_start == int(jp.window_start)
            continue
        got = getattr(tp, f.name).numpy()
        want = np.asarray(getattr(jp, f.name))
        assert got.shape == want.shape, f.name
        if want.dtype in (np.bool_, np.int32, np.int64):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            scale = max(float(np.abs(want).max()), 1e-6)
            assert float(np.abs(got - want).max()) <= rel * scale, f.name


def _torch_pool(jp):
    kw = {f.name: torch.tensor(np.array(getattr(jp, f.name))) for f in dataclasses.fields(tmp.EntityMemory)
          if f.name != "window_start"}
    return tmp.EntityMemory(window_start=int(jp.window_start), **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    jm = UniVSModel(cfg)
    rng = np.random.RandomState(0)
    images = rng.rand(1, T, H, W, 3).astype(np.float32) * 255
    cls_emb = rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = TextPrompts(embs=jnp.asarray(cls_emb)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                             text_prompts=tp, cls_emb=jnp.asarray(cls_emb)))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), images, jnp.arange(T)[None])["params"])
    modules = (build_pixel_decoder(cfg), build_decoder(cfg))
    bb = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=lambda m, y: m.backbone(m.normalize(y))))(
        params, images.reshape(T, H, W, 3))
    mf, _, _, ms = jax.jit(lambda p, f: modules[0].apply({"params": p}, f))(params["pixel_decoder"], bb)
    feats = (np.array(mf), tuple(np.array(m) for m in ms))
    tm = build_model(torch_tiny_config(), state_dict_from_flax(params), device="cpu")
    return dict(cfg=cfg, params=params, modules=modules, feats=feats, cls_emb=cls_emb, tm=tm)


def test_two_clip_steps_match_jax(setup):
    """tests/test_entity_inference.py:34-98 (relaxed thresholds), both
    packages from the same pool and features, two clips with a shift."""
    cfg, params, modules = setup["cfg"], setup["params"], setup["modules"]
    kw = dict(num_queries=cfg.decoder.num_queries, topk_candidates=4, num_prev_frames_memory=3,
              apply_cls_thres=0.0, newly_thres=0.1, consistency_thres=-1.0,
              num_dense_points=R, clip_stride=1, num_frames=T)
    jcc, tcc = JaxClipConfig(**kw), EntityClipConfig(**kw)
    jpool = jmp.create_entity_memory(E, K, cfg.decoder.hidden_dim, (16, 24), window=6,
                                     num_prompt_points=R, embd_history=4, prompt_history=4)
    tpool = _torch_pool(jpool)
    step = jax.jit(lambda p, f, pool, fi, off, first, ce: jax_clip_step(
        modules, p, f, pool, fi, off, first, ce, jcc))
    jfeats = (jnp.asarray(setup["feats"][0]), tuple(jnp.asarray(m) for m in setup["feats"][1]))
    tfeats = (torch.as_tensor(setup["feats"][0]), tuple(torch.as_tensor(m) for m in setup["feats"][1]))
    tmods = (setup["tm"].pixel_decoder, setup["tm"].decoder)
    ce_t = torch.as_tensor(setup["cls_emb"])

    jpool, _ = step(params, jfeats, jpool, jnp.arange(T), jnp.int32(0), jnp.bool_(True), setup["cls_emb"])
    with torch.no_grad():
        entity_clip_step(tmods, tfeats, tpool, list(range(T)), 0, True, ce_t, tcc)
    assert int(np.asarray(jpool.valid).sum()) > 0
    _pools_equal(tpool, jpool)

    jpool = jmp.shift_clip(jpool, stride=1)
    tmp.shift_clip(tpool, stride=1)
    _pools_equal(tpool, jpool)
    jpool, _ = step(params, jfeats, jpool, jnp.arange(1, T + 1), jnp.int32(1), jnp.bool_(False),
                    setup["cls_emb"])
    with torch.no_grad():
        entity_clip_step(tmods, tfeats, tpool, list(range(1, T + 1)), 1, False, ce_t, tcc)
    assert bool(np.asarray(jpool.prompt_valid).any()), "clip 2 re-encodes committed frames"
    _pools_equal(tpool, jpool)

    # candidate matching against the two-clip pool: same cand2slot
    rng = np.random.RandomState(3)
    cand = rng.randn(4, T, cfg.decoder.hidden_dim).astype(np.float32)
    cvalid = np.array([True, True, False, True])
    j_c2s, j_sim = jmp.match_candidates_to_memory(jpool, jnp.asarray(cand), jnp.asarray(cvalid), 0.1)
    t_c2s, t_sim = tmp.match_candidates_to_memory(tpool, torch.as_tensor(cand),
                                                  torch.as_tensor(cvalid), 0.1)
    np.testing.assert_array_equal(t_c2s.numpy(), np.asarray(j_c2s))
    np.testing.assert_allclose(t_sim.numpy(), np.asarray(j_sim), rtol=1e-4, atol=1e-5)
