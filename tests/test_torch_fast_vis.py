"""Parity of the port's fast / auxiliary video drivers and trackers
against the JAX package's on the CPU: ``FastVISDriver.run``,
``MDQEVISDriver.run`` (with and without window rollover),
``FastVPSDriver.run_vps``, ``SemanticExtractionDriver.run`` +
``semantic_features_to_masks`` on the tiny config with the same weights
(bridged by ``state_dict_from_flax``), and ``match_from_embds``,
``FastOverTracker`` and ``MDQETracker`` on the same seeded inputs.  The
decisions must be identical (order, track ids, categories, kept queries,
thresholded masks, panoptic maps and segments); scores within 1e-5,
logits and features within 1e-4 of their largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import tiny_test_config
from univs_tpu.inference import fast_vis as jfv
from univs_tpu.inference import trackers as jtr
from univs_tpu.models.univs import UniVSModel
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference import fast_vis as tfv
from univs_tpu_torch.inference import trackers as ttr
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

V, H, W, K = 7, 64, 96, 5


def _cfg(cfg):
    return dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, num_frames=2, clip_stride=1, num_frames_window=4))


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale


def _same_masks(got, want):
    _close(got, want)
    assert np.array_equal(np.asarray(got) > 0, np.asarray(want) > 0)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfg(tiny_test_config()), _cfg(torch_tiny_config())
    jm = UniVSModel(jcfg)
    rng = np.random.RandomState(0)
    bank = rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = TextPrompts(embs=jnp.asarray(bank)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                             text_prompts=tp, cls_emb=jnp.asarray(bank)))
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)), jnp.arange(2)[None])["params"]
    params = jax.tree.map(np.asarray, params)
    state = state_dict_from_flax(params)
    video = rng.randint(0, 256, (V, H, W, 3)).astype(np.uint8)
    jfast = jfv.FastVISDriver(jcfg, params)
    tfast = tfv.FastVISDriver(tcfg, state, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, bank=bank, video=video, jfast=jfast,
                tfast=tfast)


def _as(cls, driver):
    """The same driver state under a subclass (the JAX subclasses share
    the fast driver's jitted clip function, so nothing compiles again)."""
    d = cls.__new__(cls)
    d.__dict__.update(driver.__dict__)
    return d


def test_fast_vis_run_matches_jax(setup):
    want = setup["jfast"].run(setup["video"], jnp.asarray(setup["bank"]), topk=4)
    got = setup["tfast"].run(setup["video"], torch.as_tensor(setup["bank"]), topk=4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["category_id"] == w["category_id"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-5)
        assert g["mask_logits"].shape == (V, H // 4, W // 4)
        _same_masks(g["mask_logits"], w["mask_logits"])


@pytest.mark.parametrize("window_track", [None, 3])
def test_mdqe_run_matches_jax(setup, window_track):
    """window_track=3 rolls the tracker's window over twice in 7 frames."""
    want = _as(jfv.MDQEVISDriver, setup["jfast"]).run(
        setup["video"], jnp.asarray(setup["bank"]), window_track=window_track)
    got = _as(tfv.MDQEVISDriver, setup["tfast"]).run(
        setup["video"], torch.as_tensor(setup["bank"]), window_track=window_track)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g["track_id"], g["category_id"]) == (w["track_id"], w["category_id"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-5)
        assert sorted(g["masks"]) == sorted(w["masks"])
        for f in w["masks"]:
            _same_masks(g["masks"][f], w["masks"][f])


def test_fast_vps_matches_jax(setup):
    things = (1, 3)
    want_pan, want_info = _as(jfv.FastVPSDriver, setup["jfast"]).run_vps(
        setup["video"], jnp.asarray(setup["bank"]), things)
    got_pan, got_info = _as(tfv.FastVPSDriver, setup["tfast"]).run_vps(
        setup["video"], torch.as_tensor(setup["bank"]), things)
    assert len(want_info) >= 1
    assert got_info == want_info
    assert got_pan.dtype == want_pan.dtype and np.array_equal(got_pan, want_pan)


def test_semantic_extraction_and_masks_match_jax(setup):
    jd = jfv.SemanticExtractionDriver(setup["jcfg"], setup["params"])
    td = tfv.SemanticExtractionDriver(setup["tcfg"], setup["tfast"].model, device="cpu")
    wt, wm = jd.run(setup["video"], jnp.asarray(setup["bank"]))
    gt, gm = td.run(setup["video"], torch.as_tensor(setup["bank"]))
    assert gt.shape == (V, setup["tcfg"].decoder.hidden_dim, setup["tcfg"].decoder.num_queries)
    assert gm.shape == (V, H // 32, W // 32, setup["tcfg"].pixel_decoder.mask_dim)
    _close(gt, wt)
    _close(gm, wm)
    want = jfv.semantic_features_to_masks(setup["jcfg"], setup["params"], np.asarray(wt),
                                          np.asarray(wm), jnp.asarray(setup["bank"]),
                                          only_high_conf_masks=False)
    # thresholds at the medians of this input: the filter keeps some queries, not all
    conf = (1 / (1 + np.exp(-want[0][..., K - 1:]))).reshape(len(want[0]), -1).max(-1)
    qual = np.asarray(jax.vmap(lambda m: (m > 1).sum() / jnp.maximum((m > -1).sum(), 1))(
        jnp.asarray(want[1][:, ::2])))
    for kw in (dict(only_high_conf_masks=False),
               dict(apply_cls_thres=float(np.median(conf)), apply_mask_quality_thres=-1.0,
                    temporal_stride=2),
               dict(apply_cls_thres=0.0, apply_mask_quality_thres=float(np.median(qual)),
                    temporal_stride=2)):
        want = jfv.semantic_features_to_masks(setup["jcfg"], setup["params"], np.asarray(wt),
                                              np.asarray(wm), jnp.asarray(setup["bank"]), **kw)
        got = tfv.semantic_features_to_masks(setup["tcfg"], setup["tfast"].model, gt, gm,
                                             torch.as_tensor(setup["bank"]), **kw)
        assert np.array_equal(got[2], want[2])
        n_all = setup["tcfg"].decoder.num_queries
        assert 1 <= len(want[2]) < n_all if "apply_cls_thres" in kw else len(want[2]) == n_all
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_from_embds_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(12, 16).astype(np.float32)
    b = a[rng.permutation(12)] + 0.3 * rng.randn(12, 16).astype(np.float32)
    if seed == 2:  # duplicated rows: tied costs
        b[3] = b[5]
    want = np.asarray(jfv.match_from_embds(jnp.asarray(a), jnp.asarray(b)))
    got = tfv.match_from_embds(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.array_equal(got, want)


def _tracker_clips(seed, n_clips, n, T, hw):
    rng = np.random.RandomState(seed)
    base = rng.randn(n, 8).astype(np.float32)
    for c in range(n_clips):
        perm = rng.permutation(n)
        e = base[perm] + 0.05 * rng.randn(n, 8).astype(np.float32)
        e[0] = e[1]  # a tie in every clip
        yield (e, rng.rand(n, 4).astype(np.float32),
               (rng.randn(n, T, *hw) * 3).astype(np.float32))


def test_fast_over_tracker_matches_jax():
    jt, tt = jtr.FastOverTracker(), ttr.FastOverTracker()
    for c, (e, lg, m) in enumerate(_tracker_clips(0, 4, 6, 2, (5, 7))):
        jt.update(c, e, lg, m)  # overlapping clips at stride 1: the siou gate runs
        tt.update(c, e, lg, m)
    want, got = jt.results(5), tt.results(5)
    assert len(want) >= 1 and [r["track_id"] for r in got] == [r["track_id"] for r in want]
    for g, w in zip(got, want):
        assert g["category_id"] == w["category_id"] and np.array_equal(g["score"], w["score"])
        assert sorted(g["masks"]) == sorted(w["masks"])
        assert all(np.array_equal(g["masks"][f], w["masks"][f]) for f in w["masks"])


@pytest.mark.parametrize("n", [6, 24])
def test_mdqe_tracker_matches_jax(n):
    """24 instances take the tracker's downsampled soft-IoU branch."""
    T, W_ = 2, 3
    trackers = [mod.MDQETracker(num_classes=4, num_frames=T, num_frames_window_track=W_,
                                clip_stride=1, embed_dim=8) for mod in (jtr, ttr)]
    outs = [[], []]
    ws = 0
    for c, (e, lg, m) in enumerate(_tracker_clips(n, 6, n, T, (8, 10))):
        clip = {"scores": lg.max(-1), "mask_logits": m, "cls_probs": lg, "query_embeds": e,
                "frame_idx": list(range(c - ws, c - ws + T))}
        last = c == 5
        for tr, out in zip(trackers, outs):
            tr.update({k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in clip.items()},
                      is_first_clip=c == 0)
            if (c + 1 - ws) + T > tr.mem_length or last:
                out.append(tr.get_result(is_last_clip=last))
        if (c + 1 - ws) + T > trackers[0].mem_length:
            ws += trackers[0].window_frames
    assert len(outs[0]) == len(outs[1]) >= 2
    for w, g in zip(*outs):
        assert np.array_equal(g["obj_ids"], w["obj_ids"])
        assert np.array_equal(g["pred_cls_scores"], w["pred_cls_scores"])
        assert np.array_equal(g["pred_masks"], w["pred_masks"])
