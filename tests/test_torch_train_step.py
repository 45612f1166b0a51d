"""The port's train step against the JAX package's ``make_train_step`` on
the tiny training config, for detection, sot and grounding: one step's
logged losses within 1e-4, its clipped gradients (Adam's first moment
after the step, mapped through ``state_dict_from_flax``) within 1e-4 of
each tensor's scale, and the float32 params and EMA after two steps
within 1e-5, their changes from the initial params held to JAX's
changes relative to those changes' size (the EMA decay is 0.5 here, so
the EMA moves by a good part of a step).  The draws (shuffle permutations, the sot prompt sample and
PE coin, the matcher's and PointRend's points, the contrastive column
subsample) are handed across by replaying the JAX keys.  Also: the
optimizer's group and decay masks equal JAX's mapped masks, the
frozen-BN parameters update as in JAX, the three LR schedule families."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_train_util import (jax_batch, jax_key, seeded_flax_params, tiny_train_arrays,
                              torch_batch, train_cfgs)
from univs_tpu.models.univs import UniVSModel as JaxModel
from univs_tpu.parallel import train_state as jts
from univs_tpu.parallel.mesh import make_mesh
from univs_tpu.structures import TextPrompts as JaxTextPrompts
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.parallel import train_state as tts
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

TASKS = ("detection", "sot", "grounding")


# an EMA decay at which two steps move the EMA by ~half a step's change
# (at the default 0.999 it moves ~1e-3 of a step, below one float32 ulp
# of most parameters)
EMA_DECAY = 0.5


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = (c.replace(train=dataclasses.replace(c.train, ema_decay=EMA_DECAY))
                  for c in train_cfgs())
    arrays = tiny_train_arrays(jcfg)
    model = JaxModel(jcfg)
    B, T = arrays["frame_indices"].shape
    bank = jnp.asarray(arrays["bank"])
    tp = JaxTextPrompts(embs=jnp.broadcast_to(bank[None, :, None], (B, *bank.shape[:1], 1, bank.shape[1])),
                        valid=jnp.ones((B, bank.shape[0]), bool))
    params = seeded_flax_params(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        jnp.asarray(arrays["images"]), jnp.asarray(arrays["frame_indices"]), task="detection",
        text_prompts=tp, cls_emb=bank, train=True)["params"], seed=0)
    return jcfg, tcfg, arrays, model, params


def _jax_moment(opt_state, params):
    """Adam's first moment of the multi_transform state, merged over the
    two label groups, as a flax tree."""
    merged = jax.tree.map(lambda p: None, params)
    for group in opt_state.inner_states.values():
        adam = next(s for s in group.inner_state if hasattr(s, "mu"))
        merged = jax.tree.map(lambda m, g: g if not isinstance(g, optax.MaskedNode) else m,
                              merged, adam.mu, is_leaf=lambda x: x is None or isinstance(x, optax.MaskedNode))
    return merged


@pytest.fixture(scope="module")
def runs(setup):
    """Two steps of each package from the same params and key, per task,
    made on first use and shared by the module's tests."""
    cache = {}

    def get(task):
        if task not in cache:
            cache[task] = _run(setup, task)
        return cache[task]

    return get


def _run(setup, task):
    jcfg, tcfg, arrays, model, params = setup
    mesh = make_mesh(jax.devices()[:1])
    step = jts.make_train_step(jcfg, model, mesh, task=task)
    jkey, tkey = jax_key(3)
    state = jts.create_train_state(jcfg, jax.tree.map(jnp.copy, params))
    jb = jax_batch(arrays, task)
    with mesh:
        s1, jlog = step(state, jb, jkey)
        jlog = {k: float(v) for k, v in jlog.items()}
        mu1 = state_dict_from_flax(_jax_moment(s1.opt_state, s1.params))
        s2, _ = step(s1, jb, jkey)
    jparams = state_dict_from_flax(s2.params)
    jema = state_dict_from_flax(s2.ema_params)

    sd = state_dict_from_flax(params)
    tmodel = build_model(tcfg, sd, device="cpu")
    tstate = tts.create_train_state(tcfg, tmodel, sd)
    tstep = tts.make_train_step(tcfg, tmodel, task)
    tb = torch_batch(arrays, task)
    tstate, tlog = tstep(tstate, tb, tkey)
    tlog = {k: float(v) for k, v in tlog.items()}
    tmu1 = {k: v.clone().numpy() for k, v in tstate.mu.items()}
    tstate, _ = tstep(tstate, tb, tkey)
    return dict(jlog=jlog, tlog=tlog, mu=mu1, tmu=tmu1, jparams=jparams, jema=jema,
                tstate=tstate, init=sd, tmodel=tmodel)


@pytest.mark.parametrize("task", TASKS)
def test_losses_match_jax(runs, task):
    r = runs(task)
    assert set(r["jlog"]) == set(r["tlog"])
    for k, j in r["jlog"].items():
        assert abs(r["tlog"][k] - j) <= 1e-4 * max(1.0, abs(j)), (k, j, r["tlog"][k])
    assert np.isfinite(r["tlog"]["total_loss"])


@pytest.mark.parametrize("task", TASKS)
def test_clipped_gradients_match_jax(runs, task):
    """Adam's first moment after one step is (1 - b1) x the group-clipped
    gradient: the gradients and the per-group clip together."""
    r = runs(task)
    assert set(r["mu"]) == set(r["tmu"])
    for k, j in r["mu"].items():
        j = np.asarray(j, np.float32)
        scale = max(float(np.abs(j).max()), 1e-12)
        err = float(np.abs(r["tmu"][k] - j).max())
        assert err <= 1e-4 * scale or err <= 1e-10, (k, err, scale)


def _changes(r, ref, got, keys):
    """(port change, JAX change) from the initial params, float64, per key."""
    out = {}
    for k in keys:
        init = np.asarray(r["init"][k], np.float64)
        out[k] = (got[k].numpy().astype(np.float64) - init, np.asarray(ref[k], np.float64) - init)
    return out


# the changes' tolerances: one float32 ulp of a parameter near 1 is
# ~1e-3 of a 1e-4 step, so a change is held to its norm, not element-wise
GROUP_CHANGE_TOL = 1e-3  # per label group (observed <= 3e-4)
TENSOR_CHANGE_TOL = 1e-2  # per tensor (observed <= 3e-3)
# tensors whose gradient is 0 in exact arithmetic (the attention key
# biases, the biases before a one-channel-a-group GroupNorm) move by the
# rounding noise of their gradient, 1e-2 of their group's rms change or
# less: they are held by the group norm and the 1e-5 bound only
NOISE_RMS = 0.1


def _hold_changes(changes, labels, what):
    """Each label group's change, and each tensor's that moves by at least
    ``NOISE_RMS`` of its group's rms, within its tolerance of JAX's."""
    groups: dict = {}
    for k, (dt, dj) in changes.items():
        g = groups.setdefault(labels[k], [0.0, 0.0, 0])
        g[0] += float(((dt - dj) ** 2).sum())
        g[1] += float((dj ** 2).sum())
        g[2] += dj.size
    for name, (err2, ref2, _) in groups.items():
        assert ref2 > 0 and np.sqrt(err2 / ref2) <= GROUP_CHANGE_TOL, (what, name, err2, ref2)
    for k, (dt, dj) in changes.items():
        err2, ref2, n = groups[labels[k]]
        if np.sqrt((dj ** 2).mean()) >= NOISE_RMS * np.sqrt(ref2 / n):
            ratio = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
            assert ratio <= TENSOR_CHANGE_TOL, (what, k, ratio)


@pytest.mark.parametrize("task", TASKS)
def test_params_and_ema_after_two_steps(runs, task):
    r = runs(task)
    labels, _ = tts.param_groups(r["tmodel"])
    for name, ref in (("params", r["jparams"]), ("ema", r["jema"])):
        got = r["tstate"].params if name == "params" else r["tstate"].ema_params
        assert set(got) == set(ref)
        for k, v in ref.items():
            err = float(np.abs(got[k].numpy() - np.asarray(v)).max())
            assert err <= 1e-5, (name, k, err)
        _hold_changes(_changes(r, ref, got, ref), labels, name)


def test_frozen_bn_parameters_train_as_in_jax(setup, runs):
    """JAX trains FrozenBN's scale / bias / mean / var; so does the port's
    trainer (the buffers become parameters), and the working model's
    inference builds keep them as buffers."""
    r = runs("detection")
    keys = [k for k in r["init"] if ".running_mean" in k or ".running_var" in k]
    assert keys
    for k in keys:
        moved = np.abs(r["jparams"][k] - r["init"][k]).max()
        assert moved > 0, k
        assert np.abs(r["tstate"].params[k].numpy() - r["jparams"][k]).max() <= 1e-5, k
    # all four tensors of each FrozenBN, each change held to JAX's
    bns = {k.rsplit(".", 1)[0] for k in keys}
    four = [f"{b}.{t}" for b in sorted(bns) for t in ("weight", "bias", "running_mean", "running_var")]
    for k, (dt, dj) in _changes(r, r["jparams"], r["tstate"].params, four).items():
        assert np.linalg.norm(dj) > 0, k
        assert np.linalg.norm(dt - dj) <= TENSOR_CHANGE_TOL * np.linalg.norm(dj), k
    names = dict(r["tmodel"].named_parameters())
    assert all(k in names and names[k].requires_grad for k in keys)
    _, tcfg, *_ = setup
    fresh = build_model(tcfg, None, device="cpu")
    assert not any(".running_" in k for k, _ in fresh.named_parameters())


def test_group_and_decay_masks_match_jax(setup):
    _, tcfg, _, _, params = setup
    model = build_model(tcfg, state_dict_from_flax(params), device="cpu")
    tts.create_train_state(tcfg, model)
    labels, decay = tts.param_groups(model)
    jl = jts._label_params(params)
    jd = jts._decay_mask(params)
    shaped = lambda tree: jax.tree.map(lambda v, p: np.full(p.shape, v), tree, params)
    jdecay = state_dict_from_flax(shaped(jd))
    jback = state_dict_from_flax(shaped(jax.tree.map(lambda l: l == "backbone", jl)))
    assert set(jdecay) == set(decay) == set(labels)
    for k in decay:
        assert bool(jdecay[k].all()) == bool(jdecay[k].any()) == decay[k], k
        assert bool(jback[k].all()) == (labels[k] == "backbone"), k
    assert {labels[k] for k in labels} == {"backbone", "rest"}
    assert any(decay.values()) and not all(decay.values())


@pytest.mark.parametrize("family", ["multistep", "poly", "cosine"])
def test_lr_schedule_matches_jax(family):
    jcfg, tcfg = train_cfgs()
    kw = dict(lr_scheduler=family, warmup_iters=10, warmup_factor=0.1, max_iter=100,
              lr_steps=(30, 60))
    jsched = jts._lr_schedule(dataclasses.replace(jcfg.train, **kw))
    tsched = tts.lr_schedule(dataclasses.replace(tcfg.train, **kw))
    for step in (0, 1, 5, 10, 29, 30, 59, 60, 99, 100, 150):
        j = float(jsched(jnp.asarray(step, jnp.int32)))
        assert abs(tsched(step) - j) <= 1e-6 * max(abs(j), 1e-12) + 1e-12, (family, step)


def test_port_draws_depend_on_the_address_only():
    """The port's own draws are a function of (seed, path): the same
    address gives the same numbers whatever was drawn before, sibling
    addresses differ, and the replayed JAX source is addressed alike."""
    from univs_tpu_torch.utils.draws import make_key

    a, b = make_key(4, device="cpu"), make_key(4, device="cpu")
    a.fold_in(1).uniform((5,))
    x = a.fold_in(2).split(3)[1].uniform((4, 2), 0.1, 1.0)
    y = b.fold_in(2).split(3)[1].uniform((4, 2), 0.1, 1.0)
    assert torch.equal(x, y) and float(x.min()) >= 0.1
    assert not torch.equal(x, b.fold_in(2).split(3)[2].uniform((4, 2), 0.1, 1.0))
    assert sorted(b.static("decoder", 1).permutation(6).tolist()) == list(range(6))
    assert 0 <= b.randint(0, 3) < 3
    jk, tk = jax_key(0)
    want = jax.random.uniform(jax.random.split(jax.random.fold_in(jk, 7))[1], (3,))
    np.testing.assert_array_equal(tk.fold_in(7).split(2)[1].uniform((3,)).numpy(),
                                  np.asarray(want))
