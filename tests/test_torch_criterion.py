"""The port's ``UniCriterion`` against the JAX package's on the same
seeded decoder outputs: every logged loss within 1e-5 relative for
text detection (semantic CE included), sot and grounding (the
lang->vision attention losses included), with two supervised layers;
the points fixed through both packages' hooks (``_FIXED_MATCH_COORDS``,
``_FIXED_LOSS_COORDS``), the contrastive column draws replayed from the
JAX key; every layer's and video's Hungarian match identical.  Also
PointRend's importance sampling with its draws replayed, and the
batched host JV against JAX's device ``hungarian``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_util import jax_key
from univs_tpu.config import TrainConfig
from univs_tpu.losses import criterion as jc
from univs_tpu.losses.hungarian import hungarian as jax_hungarian
from univs_tpu_torch.config import TrainConfig as TTrainConfig
from univs_tpu_torch.losses import criterion as tc
from univs_tpu_torch.losses.hungarian import hungarian_batch
from univs_tpu_torch.losses.criterion import TrainTargets as TTargets

torch.set_num_threads(1)

B, Ql, Qp, T, K, C, N, P = 2, 6, 3, 2, 5, 16, 3, 24
H = W = 8
LEVELS = ((1, 1), (2, 2), (4, 4))
L = 4  # grounding: sentence + 3 words


def _arrays(seed, task):
    rng = np.random.RandomState(seed)
    Q = Ql + Qp

    def layer():
        return dict(pred_logits=rng.randn(B, Q, K).astype(np.float32) * 2,
                    pred_masks=rng.randn(B, Q, T, H, W).astype(np.float32) * 3,
                    pred_embds=rng.randn(B, Q, T, C).astype(np.float32))

    out = layer()
    out["aux_outputs"] = [layer()]
    valid = np.array([[True, True, True], [True, True, False]])
    labels = np.where(valid, rng.randint(1, K + 1, (B, N)), 0).astype(np.int32)
    ids = np.broadcast_to(np.arange(N)[None, :, None], (B, N, T)).astype(np.int32).copy()
    ids[0, 2, 0] = -1
    masks = (rng.rand(B, N, T, 2 * H, 2 * W) > 0.6).astype(np.float32)
    masks[~valid] = 0
    poi = np.array([[0, 1, 2], [1, 0, -1]], np.int32)
    if task == "grounding":
        S = sum(h * w for h, w in LEVELS)
        logits = rng.randn(B * T, Qp * L, S)
        w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        out["l2v_attn_weights"] = w.astype(np.float32)
    return out, dict(labels=labels, ids=ids, masks=masks, valid=valid, prompt_obj_ids=poi)


def _kwargs(task):
    if task == "detection":
        return dict(task=task, sem_loss=True)
    if task == "sot":
        return dict(task=task, class_loss=False)
    return dict(task=task, level_sizes=LEVELS, tokens_per_prompt=L)


def _fixed(seed):
    rng = np.random.RandomState(seed)
    match = rng.rand(P, 2).astype(np.float32)
    return match, lambda R, n: np.random.RandomState(R * 7 + n).rand(R, n, 2).astype(np.float32)


@pytest.fixture(params=["detection", "sot", "grounding"])
def task(request):
    return request.param


def _jax_matches(out, tg, cfg, match_pts):
    layers = out["aux_outputs"] + [out]
    fn = jax.jit(jax.vmap(lambda pl, pm, lb, gm, vd: jc.match_video(
        jax.random.PRNGKey(0), pl, pm, lb, gm, vd, cfg)))
    return np.stack([np.asarray(fn(l["pred_logits"][:, :Ql], l["pred_masks"][:, :Ql],
                                   tg.labels, tg.masks, tg.valid)) for l in layers])


def test_criterion_matches_jax(task, monkeypatch):
    out, tgt = _arrays(0, task)
    match_pts, loss_pts = _fixed(1)
    for mod in (jc, tc):
        monkeypatch.setattr(mod, "_FIXED_MATCH_COORDS", match_pts)
        monkeypatch.setattr(mod, "_FIXED_LOSS_COORDS", loss_pts)
    jcfg = TrainConfig(num_points=P)
    tcfg = TTrainConfig(num_points=P)
    jkey, tkey = jax_key(9)
    kw = _kwargs(task)
    cls_valid = np.array([True, True, True, True, False])

    jout = jax.tree.map(jnp.asarray, out)
    jtg = jc.TrainTargets(**{k: jnp.asarray(v) for k, v in tgt.items()})
    crit = jc.UniCriterion(jcfg, Ql, T)
    jtotal, jlog = jax.jit(lambda r, o, t, cv: crit(r, o, t, cv, **kw))(
        jkey, jout, jtg, jnp.asarray(cls_valid))

    tout = {k: (torch.as_tensor(v) if not isinstance(v, list) else
                [{kk: torch.as_tensor(vv) for kk, vv in l.items()} for l in v])
            for k, v in out.items()}
    ttg = TTargets(**{k: torch.as_tensor(v) for k, v in tgt.items()})
    tcrit = tc.UniCriterion(tcfg, Ql, T)
    ttotal, tlog = tcrit(tkey, tout, ttg, torch.as_tensor(cls_valid), **kw)

    assert set(jlog) == set(tlog)
    for k in jlog:
        j, t = float(jlog[k]), float(tlog[k])
        assert abs(t - j) <= 1e-5 * max(abs(j), 1e-6), (k, j, t)
    assert abs(float(ttotal) - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    if task == "grounding":
        assert {f"loss_l2v_attn_weight_{i}" for i in range(3)} <= set(tlog)
    want = _jax_matches(jout, jtg, jcfg, match_pts)
    np.testing.assert_array_equal(tcrit.last_matches.numpy(), want)


def test_uncertainty_point_coords_replays_jax_draws():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 12, 10).astype(np.float32)
    jcfg = TrainConfig(num_points=40)
    jkey, tkey = jax_key(2)
    want = jc.uncertainty_point_coords(jkey, jnp.asarray(logits), 40, jcfg.oversample_ratio,
                                       jcfg.importance_sample_ratio)
    got = tc.uncertainty_point_coords(torch.as_tensor(logits), TTrainConfig(num_points=40), tkey)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hungarian_batch_matches_jax():
    rng = np.random.RandomState(6)
    costs = rng.rand(3, 2, 4, 9).astype(np.float32)
    costs[1, 0, :, 2:4] = 0.25  # ties
    valid = rng.rand(3, 2, 4) > 0.3
    valid[2, 1] = False
    got = hungarian_batch(torch.as_tensor(costs), torch.as_tensor(valid)).numpy()
    fn = jax.jit(lambda c, v: jax_hungarian(c, row_valid=v))
    for i in range(3):
        for b in range(2):
            np.testing.assert_array_equal(got[i, b], np.asarray(fn(costs[i, b], valid[i, b])))
