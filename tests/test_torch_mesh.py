"""The model axis in the port (``parallel/mesh.py``): four gloo processes
on the CPU as a (data=2, model=2) layout, each frame group holding one
video of a B=2 batch and each rank encoding its one frame of T=2, run two
steps of the tiny detection train step and one each of sot and grounding
from the same weights and key.  Every rank's logged losses, float32
masters and EMA equal the one-process step's on the whole batch within 1e-5, and Adam's
first moment (the global gradient, held separately over the encoder's and
the decoder's parameters, so that a gradient counted twice on either side
fails) within 1e-4; so do one BoxVIS step with its EMA teacher, and a
detection step at T=3, which the model axis does not divide (every rank
encodes the whole clip).  The layout and its groups are JAX
``make_mesh``'s, the gathered encode equals the whole encode frame by
frame, the gather's backward is this rank's slice of its gradient,
unsummed, and the (2, 2) world matches the JAX package's own (2, 2)
``make_train_step`` on four CPU devices within 1e-4."""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch_train_util import (jax_batch, jax_key, seeded_flax_params, tiny_train_arrays,
                              torch_batch, train_cfgs, zero_gradient_in_law)
from univs_tpu.models.univs import UniVSModel as JaxModel
from univs_tpu.parallel import train_state as jts
from univs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from univs_tpu.structures import TextPrompts as JaxTextPrompts
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.parallel import ddp
from univs_tpu_torch.parallel import mesh as tmesh
from univs_tpu_torch.parallel import train_state as tts
from univs_tpu_torch.utils.draws import make_key
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

TASKS = ("detection", "sot", "grounding")
# detection's second step holds the masters and EMA after a second update;
# sot and grounding differ from it before the encoder, in the first step
STEPS = {"detection": 2, "sot": 1, "grounding": 1}
WORLD, MODEL = 4, 2
EMA_DECAY = 0.5
TOL = 1e-5
# Adam's first moment is a gradient: sums over the pixels in float32,
# whose order changes when the frames split (the encoder's part reads
# 0.8-1.0e-5 in norm and up to 1.4e-5 of its largest element); held as
# the port's gradients are held to JAX's (test_torch_train_step).  A part
# counted twice is off by its own size
MU_TOL = 1e-4
JAX_TOL = 1e-4
# JAX's own layouts' first moments differ by up to 8.7e-5 of a part's norm
# on this step ((2, 1) and (2, 2) against one device; the port's world
# reads 1.1e-4 against JAX's (2, 2))
JAX_MU_TOL = 5e-4


def _cfg(frames: int = 2, **train):
    """The tiny training config at ``frames`` frames, with ``train``'s
    fields replaced."""
    _, cfg = train_cfgs()
    return cfg.replace(num_frames=frames, train=dataclasses.replace(
        cfg.train, ema_decay=EMA_DECAY, **train))


# T=3 over a model axis of 2: every rank encodes the whole clip, and every
# gradient is a copy of the frame group's.  Unclipped as well: a uniform
# error in the gradients' scale passes unseen through a clip that is active
# (the clipped step holds the masters: unclipped, Adam's update of a
# gradient near its epsilon follows the sum's float32 order, 1.06e-5)
T3 = {"t3": _cfg(3), "t3_unclipped": _cfg(3, clip_gradients_value=1e6)}
# BoxVIS with its EMA teacher: the teacher's forward splits the frames too
BOXVIS = _cfg(boxvis_enabled=True, boxvis_ema_enabled=True, pseudo_score_thresh=0.0)


def _steps(cfg, task, batch, make_step, n, params=None, key=None):
    """``n`` steps from the seeded weights (or ``params``): (the first
    step's logged losses, Adam's first moment after it, the masters and
    EMA after the last)."""
    model = build_model(cfg, params, seed=4, device="cpu")
    state = tts.create_train_state(cfg, model, params)
    step = make_step(cfg, model, task)
    key = make_key(6, device="cpu") if key is None else key
    state, logged = step(state, batch, key)
    mu = {k: v.clone() for k, v in state.mu.items()}
    for _ in range(n - 1):
        state, _ = step(state, batch, key)
    return ({k: float(v) for k, v in logged.items()}, mu,
            {k: v.clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.ema_params.items()})


def _gather_backward(mesh):
    """A gathered [b * t/m, 2] block, its rank-dependent incoming gradient
    and what reached the block."""
    b, t = 2, 2
    x = (torch.arange(b * t // MODEL * 2, dtype=torch.float32).reshape(-1, 2)
         + 100 * dist.get_rank()).requires_grad_(True)
    y = tmesh.gather_frames(x, mesh, b, t)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(dist.get_rank()))
    y.backward(g)
    return x.detach(), y.detach(), g, x.grad


def _worker(rank, port, out_path, jax_params_path):
    torch.set_num_threads(1)
    ddp.init_distributed("gloo", f"tcp://127.0.0.1:{port}", rank, WORLD)
    try:
        mesh = tmesh.make_mesh(MODEL)
        res = {"coords": (mesh.data_rank, mesh.data_size, mesh.model_rank, mesh.model_size),
               "data_group": dist.get_process_group_ranks(mesh.data_group),
               "frame_group": dist.get_process_group_ranks(mesh.frame_group),
               "gather": _gather_backward(mesh)}
        world_step = lambda cfg, model, task: ddp.make_train_step(cfg, model, task, mesh=mesh)
        cfg = _cfg()
        arrays = tiny_train_arrays(cfg)
        with torch.no_grad():
            model = build_model(cfg, None, seed=4, device="cpu")
            images = torch.as_tensor(arrays["images"])
            res["encode"] = model.encode_features(images, frames=mesh)
        shard = lambda a, task: ddp.shard_batch(torch_batch(a, task), mesh.data_rank,
                                                mesh.data_size)
        for task in TASKS:
            res[task] = _steps(cfg, task, shard(arrays, task), world_step, STEPS[task])
        res["boxvis"] = _steps(BOXVIS, "detection", shard(arrays, "detection"), world_step, 1)
        for name, cfg3 in T3.items():
            res[name] = _steps(cfg3, "detection", shard(tiny_train_arrays(cfg, T=3), "detection"),
                               world_step, 1)
        # against JAX's (2, 2) step: its weights and its key
        res["jax"] = _steps(cfg, "detection", shard(arrays, "detection"), world_step, 1,
                            params=torch.load(jax_params_path), key=jax_key(3)[1])
        torch.save(res, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_setup():
    jcfg, _ = (c.replace(train=dataclasses.replace(c.train, ema_decay=EMA_DECAY))
               for c in train_cfgs())
    arrays = tiny_train_arrays(jcfg)
    model = JaxModel(jcfg)
    B = arrays["frame_indices"].shape[0]
    bank = jnp.asarray(arrays["bank"])
    tp = JaxTextPrompts(embs=jnp.broadcast_to(bank[None, :, None], (B, bank.shape[0], 1,
                                                                    bank.shape[1])),
                        valid=jnp.ones((B, bank.shape[0]), bool))
    params = seeded_flax_params(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        jnp.asarray(arrays["images"]), jnp.asarray(arrays["frame_indices"]), task="detection",
        text_prompts=tp, cls_emb=bank, train=True)["params"], seed=0)
    return jcfg, arrays, model, params


def _jax_moment(opt_state, params):
    """Adam's first moment of the multi_transform state, merged over the
    label groups, as a flax tree."""
    merged = jax.tree.map(lambda p: None, params)
    for group in opt_state.inner_states.values():
        adam = next(s for s in group.inner_state if hasattr(s, "mu"))
        merged = jax.tree.map(lambda m, g: g if not isinstance(g, optax.MaskedNode) else m,
                              merged, adam.mu,
                              is_leaf=lambda x: x is None or isinstance(x, optax.MaskedNode))
    return merged


def _jax_world_step(jcfg, arrays, model, params):
    """JAX's detection step on a (data=2, model=2) mesh of four CPU
    devices: (total_loss, first moment, params) as state_dicts."""
    mesh = jax_make_mesh(jax.devices()[:WORLD], MODEL)
    step = jts.make_train_step(jcfg, model, mesh, task="detection")
    state = jts.create_train_state(jcfg, jax.tree.map(jnp.copy, params))
    with mesh:
        s1, logged = step(state, jax_batch(arrays, "detection"), jax_key(3)[0])
        total = float(logged["total_loss"])
    return total, state_dict_from_flax(_jax_moment(s1.opt_state, s1.params)), \
        state_dict_from_flax(s1.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the references, made while the ranks
    run: the one-process steps and JAX's (2, 2) step."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("mesh")
    jcfg, jarrays, jmodel, jparams = _jax_setup()
    sd = state_dict_from_flax(jparams)
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, tmp / "jax_params.pt")
    out = str(tmp / "rank")
    ctx = mp.spawn(_worker, args=(_free_port(), out, str(tmp / "jax_params.pt")), nprocs=WORLD,
                   join=False)
    cfg = _cfg()
    arrays = tiny_train_arrays(cfg)
    whole = {task: _steps(cfg, task, torch_batch(arrays, task), tts.make_train_step,
                          STEPS[task]) for task in TASKS}
    whole["boxvis"] = _steps(BOXVIS, "detection", torch_batch(arrays, "detection"),
                             tts.make_train_step, 1)
    batch = torch_batch(tiny_train_arrays(cfg, T=3), "detection")
    for name, cfg3 in T3.items():
        whole[name] = _steps(cfg3, "detection", batch, tts.make_train_step, 1)
    with torch.no_grad():
        model = build_model(cfg, None, seed=4, device="cpu")
        whole["encode"] = model.encode_features(torch.as_tensor(arrays["images"]))
    jax_world = _jax_world_step(jcfg, jarrays, jmodel, jparams)
    while not ctx.join():
        pass
    ranks = [torch.load(f"{out}.{r}") for r in range(WORLD)]
    return cfg, ranks, whole, jax_world


def _hold_losses(got, want, tol):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= tol * max(1.0, abs(v)), (k, got[k], v)


def _hold_masters(cfg, got, want, init):
    assert set(got) == set(want)
    for k, v in want.items():
        if zero_gradient_in_law(k, cfg):  # rounding noise moved by Adam: under a step
            moved = max(float((v - init[k]).abs().max()), float((got[k] - init[k]).abs().max()))
            assert moved < cfg.train.lr, (k, moved)
        else:
            err = float((got[k] - v).abs().max())
            assert err <= TOL, (k, err)


def _hold_moment(got, want, part, tol=MU_TOL):
    """The first moment of one part's tensors (the encoder's or the rest):
    the part's error norm within ``tol`` of its norm, and each tensor
    within ``tol`` of the part's largest element."""
    names = [k for k in want if k.startswith(tts.ENCODER) == (part == "encoder")]
    assert names
    scale = max(float(want[k].abs().max()) for k in names)
    d2 = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in names)
    n2 = sum(float((want[k].double() ** 2).sum()) for k in names)
    assert (d2 / n2) ** 0.5 <= tol, (part, (d2 / n2) ** 0.5)
    for k in names:
        err = float((got[k] - want[k]).abs().max())
        assert err <= tol * scale, (k, err, scale)


def _init(cfg):
    return tts.create_train_state(cfg, build_model(cfg, None, seed=4, device="cpu")).params


# -- the layout -----------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_layout_is_jax_make_mesh(n):
    devices = jax_make_mesh(jax.devices()[:n], MODEL).devices
    ids = np.vectorize(lambda d: d.id)(devices)
    assert devices.shape == (n // MODEL, MODEL)
    np.testing.assert_array_equal(tmesh.mesh_layout(n, MODEL), ids)
    for r in range(n):
        assert tuple(np.argwhere(ids == r)[0]) == divmod(r, MODEL)


def test_indivisible_world_is_refused():
    with pytest.raises(AssertionError):
        jax_make_mesh(jax.devices()[:3], MODEL)
    with pytest.raises(ValueError):
        tmesh.mesh_layout(3, MODEL)
    with pytest.raises(ValueError):  # a world of one process
        tmesh.make_mesh(MODEL)
    assert tmesh.make_mesh(1) == tmesh.Mesh(0, 1, 0, 1)


def test_ranks_sit_where_jax_puts_their_devices(runs):
    _, ranks, _, _ = runs
    layout = tmesh.mesh_layout(WORLD, MODEL)
    for r, res in enumerate(ranks):
        i, j = divmod(r, MODEL)
        assert res["coords"] == (i, WORLD // MODEL, j, MODEL)
        assert res["frame_group"] == list(layout[i])
        assert res["data_group"] == list(layout[:, j])


def test_frame_slice_and_its_fallback():
    m = [tmesh.Mesh(0, 1, r, MODEL) for r in range(MODEL)]
    assert [tmesh.frame_slice(4, x) for x in m] == [slice(0, 2), slice(2, 4)]
    assert [tmesh.frame_slice(3, x) for x in m] == [slice(0, 3)] * 2
    assert tmesh.frame_slice(4, None) == slice(0, 4)
    assert [tmesh.splits_frames(t, m[1]) for t in (2, 3)] == [True, False]


# -- the encode and the gather ----------------------------------------------------------


def _frames_of(x, b, t):
    return x.reshape(b, t, *x.shape[1:])


def test_split_encode_equals_the_whole_frame_by_frame():
    """Each rank's ``frame_slice`` encoded alone, concatenated over the
    ranks, is the whole clip's encode (B=2, T=4 over two ranks)."""
    cfg = _cfg()
    images = torch.as_tensor(tiny_train_arrays(cfg, B=2, T=4)["images"])
    model = build_model(cfg, None, seed=4, device="cpu")
    with torch.no_grad():
        whole = model.encode_features(images)
        parts = [model.encode_features(images[:, tmesh.frame_slice(4, tmesh.Mesh(0, 1, r, 2))])
                 for r in range(2)]
    for i, w in enumerate([whole[0], *whole[1]]):
        got = torch.cat([_frames_of([p[0], *p[1]][i], 2, 2) for p in parts], dim=1)
        err = float((got - _frames_of(w, 2, 4)).abs().max())
        assert err <= TOL * max(1.0, float(w.abs().max())), (i, err)


def test_gathered_encode_equals_the_whole(runs):
    _, ranks, whole, _ = runs
    want = [whole["encode"][0], *whole["encode"][1]]
    for res in ranks:
        got = [res["encode"][0], *res["encode"][1]]
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= TOL * max(1.0, float(w.abs().max()))


def test_gather_backward_is_this_ranks_slice_unsummed(runs):
    """The forward places each rank's frames in b-major order; the
    backward hands back the rank's own slice of its incoming gradient, not
    the frame group's sum of it (which a gather like ``ddp._GatherRows``
    would return, counting the group's copies of the loss m times)."""
    _, ranks, _, _ = runs
    b, t, n = 2, 2, 2 // MODEL
    for r, res in enumerate(ranks):
        x, y, g, grad = res["gather"]
        group = list(tmesh.mesh_layout(WORLD, MODEL)[r // MODEL])
        want_y = torch.cat([ranks[q]["gather"][0].reshape(b, n, 2) for q in group], dim=1)
        assert torch.equal(y, want_y.reshape(b * t, 2))
        j = r % MODEL
        want = g.reshape(b, t, 2)[:, j * n:(j + 1) * n].reshape(b * n, 2)
        assert torch.equal(grad, want)
        summed = sum(ranks[q]["gather"][2] for q in group).reshape(b, t, 2)
        assert not torch.equal(grad, summed[:, j * n:(j + 1) * n].reshape(b * n, 2))


# -- the train step ------------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_world_losses_equal_the_global_batch(runs, task):
    _, ranks, whole, _ = runs
    for res in ranks:
        _hold_losses(res[task][0], whole[task][0], TOL)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
@pytest.mark.parametrize("task", TASKS)
def test_world_first_moment_equals_the_global_gradient(runs, task, part):
    _, ranks, whole, _ = runs
    for res in ranks:
        _hold_moment(res[task][1], whole[task][1], part)


@pytest.mark.parametrize("task", TASKS)
def test_world_masters_and_ema_after_the_steps(runs, task):
    cfg, ranks, whole, _ = runs
    init = _init(cfg)
    for res in ranks:
        for i in (2, 3):
            _hold_masters(cfg, res[task][i], whole[task][i], init)
        for i in (2, 3):  # every rank holds the same masters and EMA
            assert all(torch.equal(res[task][i][k], ranks[0][task][i][k]) for k in res[task][i])


def test_world_boxvis_teacher_step(runs):
    """One step of BoxVIS with its EMA teacher, whose forward splits the
    frames too (its pseudo masks supervise the learnable queries)."""
    _, ranks, whole, _ = runs
    init = _init(BOXVIS)
    logged, mu, params, ema = whole["boxvis"]
    for res in ranks:
        _hold_losses(res["boxvis"][0], logged, TOL)
        for part in ("encoder", "decoder"):
            _hold_moment(res["boxvis"][1], mu, part)
        _hold_masters(BOXVIS, res["boxvis"][2], params, init)
        _hold_masters(BOXVIS, res["boxvis"][3], ema, init)


def test_indivisible_clip_is_encoded_whole_on_every_rank(runs):
    """T=3 over a model axis of 2: JAX's fallback, the same step."""
    _, ranks, whole, _ = runs
    cfg3 = T3["t3"]
    init = _init(cfg3)
    logged, mu, params, _ = whole["t3"]
    for res in ranks:
        _hold_losses(res["t3"][0], logged, TOL)
        for part in ("encoder", "decoder"):
            _hold_moment(res["t3"][1], mu, part)
        _hold_masters(cfg3, res["t3"][2], params, init)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_indivisible_clip_gradient_unclipped(runs, part):
    """The same step without the clip: the world's gradient at its scale."""
    _, ranks, whole, _ = runs
    for res in ranks:
        _hold_moment(res["t3_unclipped"][1], whole["t3_unclipped"][1], part)


def test_world_matches_jax_model_axis(runs):
    """The port's (2, 2) world against ``univs_tpu``'s ``make_train_step``
    on a (data=2, model=2) mesh: total_loss and the params after one
    detection step within 1e-4, and Adam's first moment by part within
    ``JAX_MU_TOL``."""
    _, ranks, _, (total, mu, params) = runs
    mu = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in mu.items()}
    for res in ranks:
        logged, tmu, tparams, _ = res["jax"]
        assert abs(logged["total_loss"] - total) <= JAX_TOL * max(1.0, abs(total))
        assert set(tparams) == set(params)
        for k, v in params.items():
            assert float(np.abs(tparams[k].numpy() - np.asarray(v)).max()) <= JAX_TOL, k
        for part in ("encoder", "decoder"):
            _hold_moment(tmu, mu, part, JAX_MU_TOL)


def test_step_takes_a_group_or_a_mesh():
    """The data axis alone is a mesh of model axis 1; a step given both a
    process group and a mesh is refused."""
    assert tmesh.data_mesh() == tmesh.Mesh(0, 1, 0, 1)  # a world of one process
    with pytest.raises(ValueError):
        ddp.make_train_step(_cfg(), None, group=object(), mesh=tmesh.Mesh(0, 1, 0, 1))
