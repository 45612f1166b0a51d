"""BoxVIS in the port against the JAX package: the box-projection loss
and the EMA teacher's pseudo masks on seeded arrays (1e-6), and the tiny
detection train step with ``boxvis_enabled`` on box-region targets (the
seeded rectangles of ``tests/test_train_tasks.py``), once with the
teacher off and once on (``pseudo_score_thresh`` 0, so the gated pseudo
BCE + dice runs on random weights): the logged losses within 1e-4 and
the float32 params and EMA after two steps within 1e-5.  The draws are
replayed from the JAX keys, the teacher's included (its shuffle at the
split the student leaves unused, its matcher at ``fold_in(r_crit,
31337)``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_util import (jax_batch, jax_key, seeded_flax_params, tiny_train_arrays,
                              torch_batch, train_cfgs, zero_gradient_in_law)
from univs_tpu.config import TrainConfig
from univs_tpu.losses import criterion as jc
from univs_tpu.models.univs import UniVSModel as JaxModel
from univs_tpu.parallel import train_state as jts
from univs_tpu.parallel.mesh import make_mesh
from univs_tpu.structures import TextPrompts as JaxTextPrompts
from univs_tpu_torch.config import TrainConfig as TTrainConfig
from univs_tpu_torch.losses import criterion as tc
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.parallel import train_state as tts
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

EMA_DECAY = 0.5  # the teacher of the second step differs from the first's


@pytest.mark.parametrize("gt_hw", [(16, 12), (32, 24), (8, 6), (20, 15)])
def test_loss_masks_box_supervised_matches_jax(gt_hw):
    """The projection dice at the prediction's size, the box masks
    nearest-resized from the same size, a multiple, a half and a
    non-integer ratio (half-pixel centres)."""
    torch.set_num_threads(1)
    rng = np.random.RandomState(sum(gt_hw))
    R, H, W = 6, 16, 12
    logits = (rng.randn(R, H, W) * 3).astype(np.float32)
    boxes = np.zeros((R, *gt_hw), np.float32)
    for r in range(R - 1):  # the last row empty
        y0, x0 = rng.randint(0, gt_hw[0] // 2), rng.randint(0, gt_hw[1] // 2)
        boxes[r, y0:y0 + gt_hw[0] // 2, x0:x0 + gt_hw[1] // 2] = 1.0
    valid = np.array([1, 1, 0, 1, 1, 1], np.float32)
    want = jc.loss_masks_box_supervised(jnp.asarray(logits), jnp.asarray(boxes),
                                        jnp.asarray(valid), jnp.float32(7.0))
    got = tc.loss_masks_box_supervised(torch.as_tensor(logits), torch.as_tensor(boxes),
                                       torch.as_tensor(valid), torch.tensor(7.0))
    assert set(got) == set(want) == {"loss_mask_proj"}
    np.testing.assert_allclose(got["loss_mask_proj"].numpy(), np.asarray(want["loss_mask_proj"]),
                               rtol=1e-6, atol=1e-6)


def test_boxvis_teacher_pseudo_masks_matches_jax():
    """Pseudo masks and confidences on seeded teacher outputs, the matcher's
    points replayed from the JAX key: the same assignments, masks and
    scores within 1e-6."""
    torch.set_num_threads(1)
    rng = np.random.RandomState(3)
    B, Ql, K, T, H, W, N = 2, 6, 4, 2, 8, 8, 3
    logits = (rng.randn(B, Ql, K) * 2).astype(np.float32)
    masks = (rng.randn(B, Ql, T, H, W) * 3).astype(np.float32)
    labels = rng.randint(1, K + 1, (B, N)).astype(np.int32)
    valid = np.array([[True, True, True], [True, True, False]])
    box = np.zeros((B, N, T, H, W), np.float32)
    for b in range(B):
        for n in range(N):
            if valid[b, n]:
                y0, x0 = rng.randint(0, H // 2, 2)
                box[b, n, :, y0:y0 + H // 2, x0:x0 + W // 2] = 1.0
    ids = np.broadcast_to(np.arange(N)[None, :, None], (B, N, T)).astype(np.int32)
    poi = np.full((B, N), -1, np.int32)
    cls_valid = np.array([True, True, True, False])
    jt = jc.TrainTargets(labels=jnp.asarray(labels), ids=jnp.asarray(ids), masks=jnp.asarray(box),
                         valid=jnp.asarray(valid), prompt_obj_ids=jnp.asarray(poi))
    tt = tc.TrainTargets(labels=torch.as_tensor(labels).long(), ids=torch.as_tensor(ids).long(),
                         masks=torch.as_tensor(box), valid=torch.as_tensor(valid),
                         prompt_obj_ids=torch.as_tensor(poi).long())
    cfg_j, cfg_t = TrainConfig(num_points=32), TTrainConfig(num_points=32)
    jkey, tkey = jax_key(11)
    pm_j, sc_j = jc.boxvis_teacher_pseudo_masks(jkey, jnp.asarray(logits), jnp.asarray(masks), jt,
                                                jnp.asarray(cls_valid), cfg_j)
    pm_t, sc_t = tc.boxvis_teacher_pseudo_masks(tkey, torch.as_tensor(logits),
                                                torch.as_tensor(masks), tt,
                                                torch.as_tensor(cls_valid), cfg_t)
    assert not pm_t.requires_grad and not sc_t.requires_grad
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-6, atol=1e-6)
    assert float(sc_t[1, 2]) == 0.0 and float(sc_t.max()) > 0


def _box_arrays(cfg):
    """``tiny_train_arrays`` with box-region masks: one seeded rectangle per
    valid target, the same over its frames (``tests/test_train_tasks.py``)."""
    a = tiny_train_arrays(cfg)
    B, N, T, h, w = a["masks"].shape
    rng = np.random.RandomState(7)
    boxes = np.zeros_like(a["masks"])
    for b in range(B):
        for n in range(N):
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            if a["valid"][b, n]:
                boxes[b, n, :, y0:y0 + h // 2, x0:x0 + w // 2] = 1.0
    a["masks"] = boxes
    return a


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jcfg, tcfg = (c.replace(train=dataclasses.replace(c.train, ema_decay=EMA_DECAY,
                                                      boxvis_enabled=True))
                  for c in train_cfgs())
    arrays = _box_arrays(jcfg)
    model = JaxModel(jcfg)
    B = arrays["frame_indices"].shape[0]
    bank = jnp.asarray(arrays["bank"])
    tp = JaxTextPrompts(embs=jnp.broadcast_to(bank[None, :, None], (B, bank.shape[0], 1, bank.shape[1])),
                        valid=jnp.ones((B, bank.shape[0]), bool))
    params = seeded_flax_params(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        jnp.asarray(arrays["images"]), jnp.asarray(arrays["frame_indices"]), task="detection",
        text_prompts=tp, cls_emb=bank, train=True)["params"], seed=0)
    return jcfg, tcfg, arrays, model, params


def _teacher(cfg, on: bool):
    return cfg.replace(train=dataclasses.replace(cfg.train, boxvis_ema_enabled=on,
                                                 pseudo_score_thresh=0.0))


@pytest.fixture(scope="module")
def runs(setup):
    cache = {}

    def get(teacher):
        if teacher not in cache:
            cache[teacher] = _run(setup, teacher)
        return cache[teacher]

    return get


def _run(setup, teacher):
    jcfg, tcfg, arrays, model, params = setup
    jcfg, tcfg = _teacher(jcfg, teacher), _teacher(tcfg, teacher)
    mesh = make_mesh(jax.devices()[:1])
    step = jts.make_train_step(jcfg, model, mesh, task="detection")
    jkey, tkey = jax_key(5)
    state = jts.create_train_state(jcfg, jax.tree.map(jnp.copy, params))
    jb = jax_batch(arrays, "detection")
    with mesh:
        s1, jlog = step(state, jb, jkey)
        jlog = {k: float(v) for k, v in jlog.items()}
        s2, _ = step(s1, jb, jkey)
    sd = state_dict_from_flax(params)
    tmodel = build_model(tcfg, sd, device="cpu")
    tstate = tts.create_train_state(tcfg, tmodel, sd)
    tstep = tts.make_train_step(tcfg, tmodel, "detection")
    tb = torch_batch(arrays, "detection")
    tstate, tlog = tstep(tstate, tb, tkey)
    tlog = {k: float(v) for k, v in tlog.items()}
    tstate, _ = tstep(tstate, tb, tkey)
    return dict(jlog=jlog, tlog=tlog, jparams=state_dict_from_flax(s2.params),
                jema=state_dict_from_flax(s2.ema_params), tstate=tstate, teacher=tstep.teacher,
                init={k: np.asarray(v) for k, v in sd.items()})


@pytest.mark.parametrize("teacher", [False, True])
def test_boxvis_step_losses_match_jax(runs, teacher):
    r = runs(teacher)
    assert set(r["jlog"]) == set(r["tlog"])
    # a BoxVIS config trains the projection loss on every supervised layer
    assert "loss_mask_proj" in r["tlog"] and "loss_mask_proj_0" in r["tlog"]
    for k, j in r["jlog"].items():
        assert abs(r["tlog"][k] - j) <= 1e-4 * max(1.0, abs(j)), (k, j, r["tlog"][k])
    assert (r["teacher"] is not None) == teacher


@pytest.mark.parametrize("teacher", [False, True])
def test_boxvis_params_and_ema_after_two_steps(setup, runs, teacher):
    """Every tensor within 1e-5 of JAX's, but the biases whose gradient is
    0 in exact arithmetic (``zero_gradient_in_law``): those move by rounding
    noise, less than one step (lr) in both packages."""
    tcfg = setup[1]
    r = runs(teacher)
    lr = tcfg.train.lr
    for name, ref in (("params", r["jparams"]), ("ema", r["jema"])):
        got = r["tstate"].params if name == "params" else r["tstate"].ema_params
        assert set(got) == set(ref)
        for k, v in ref.items():
            err = float(np.abs(got[k].numpy() - np.asarray(v)).max())
            if zero_gradient_in_law(k, tcfg):
                init = r["init"][k]
                moved = max(float(np.abs(np.asarray(v) - init).max()),
                            float(np.abs(got[k].numpy() - init).max()))
                assert moved < lr, (name, k, moved)
            else:
                assert err <= 1e-5, (name, k, err)


def test_teacher_changes_the_loss(runs):
    """The teacher's pseudo BCE + dice take the learnable half of
    ``loss_mask`` / ``loss_dice``: with the teacher on they differ from the
    teacher-off step's (where the prompt half alone gives them)."""
    off, on = runs(False)["tlog"], runs(True)["tlog"]
    assert off["loss_mask_proj"] == on["loss_mask_proj"]
    assert abs(off["loss_mask"] - on["loss_mask"]) > 1e-6
    assert abs(off["loss_dice"] - on["loss_dice"]) > 1e-6
