"""End-to-end parity of the PyTorch port's prompt-guided driver against
the JAX package's on the CPU, tiny config: ``VOSDriver.run`` (8 frames of
64x96, T=2, stride 1, a 6-frame window so the video spans two encodes
and several emissions; three objects first appearing at frames 0, 0 and
3 and one that never appears) must give byte-identical label maps in
the 'prompt' and 'prompt+learn' modes, and ``run_grounding`` (two
expressions padded to capacity 3) identical per-expression masks.  The
maps must not reduce to the injected GT frames: objects are segmented on
frames that hold no GT."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import tiny_test_config
from univs_tpu.inference.driver import VOSDriver as JaxVOSDriver
from univs_tpu.models.univs import UniVSModel
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference.driver import VOSDriver
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

V, H, W, K = 8, 64, 96, 3
FAF = np.array([0, 0, 3, -1])


def _vos_cfg(cfg):
    inf = dataclasses.replace(cfg.inference, num_frames=2, clip_stride=1, num_frames_window=6)
    prompt = dataclasses.replace(cfg.prompt, num_prev_frames_memory=3)
    return dataclasses.replace(cfg, inference=inf, prompt=prompt)


def elliptical_gt(faf, V, h4, w4, seed):
    """[N, V, h4, w4] seeded ellipses at each object's first frame."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((len(faf), V, h4, w4), np.float32)
    yy, xx = np.mgrid[0:h4, 0:w4]
    for n, f in enumerate(faf):
        cy, cx = rng.uniform(0.25, 0.75) * h4, rng.uniform(0.25, 0.75) * w4
        ry, rx = rng.uniform(0.15, 0.3) * h4, rng.uniform(0.15, 0.3) * w4
        if f >= 0:
            gt[n, f] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return gt


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _vos_cfg(tiny_test_config()), _vos_cfg(torch_tiny_config())
    jm = UniVSModel(jcfg)
    rng = np.random.RandomState(0)
    cls_emb = rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = TextPrompts(embs=jnp.asarray(cls_emb)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                             text_prompts=tp, cls_emb=jnp.asarray(cls_emb)))
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)), jnp.arange(2)[None])["params"]
    params = jax.tree.map(np.asarray, params)
    video = rng.randint(0, 256, (V, H, W, 3)).astype(np.uint8)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, state=state_dict_from_flax(params),
                cls_emb=cls_emb, video=video)


@pytest.mark.parametrize("query_mode", ["prompt", "prompt+learn"])
def test_run_same_label_maps(setup, query_mode):
    N = len(FAF)
    gt = elliptical_gt(FAF, V, H // 4, W // 4, seed=1)
    ov = np.ones(N, bool)
    jd = JaxVOSDriver(setup["jcfg"], setup["params"], capacity=N, num_classes=K,
                      query_mode=query_mode)
    want = jd.run(setup["video"], gt, FAF, ov, jnp.asarray(setup["cls_emb"]))
    td = VOSDriver(setup["tcfg"], setup["state"], capacity=N, num_classes=K,
                   query_mode=query_mode, device="cpu")
    got = td.run(setup["video"], gt, FAF, ov, torch.as_tensor(setup["cls_emb"]))
    assert got.dtype == np.uint8 and got.shape == (V, H, W)
    np.testing.assert_array_equal(got, np.asarray(want))
    no_gt = [f for f in range(V) if f not in set(FAF.tolist())]
    assert (got[no_gt] > 0).any(), "objects must be segmented beyond the injected GT frames"
    assert not (got == N).any(), "the object that never appears gets no pixel"


def test_run_grounding_same_masks(setup):
    Dt = setup["jcfg"].decoder.clip_cls_emb_dim
    rng = np.random.RandomState(2)
    embs = rng.randn(1, 3, 78, Dt).astype(np.float32)
    embs[:, 2] = 0.0  # the pad row, as PrepareTargets.grounding_inputs(pad_to=3)
    valid = np.array([[True, True, False]])
    jd = JaxVOSDriver(setup["jcfg"], setup["params"], capacity=3, num_classes=K)
    want = jd.run_grounding(setup["video"], jnp.asarray(embs), jnp.asarray(valid),
                            jnp.asarray(setup["cls_emb"]), n_expressions=2)
    td = VOSDriver(setup["tcfg"], setup["state"], capacity=3, num_classes=K, device="cpu")
    got = td.run_grounding(setup["video"], embs, valid, setup["cls_emb"], n_expressions=2)
    assert got.dtype == np.uint8 and got.shape == (2, V, H, W)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert all(got[e].any() for e in range(2)), "each expression segments something"
    with pytest.raises(ValueError, match="capacity"):
        td.run_grounding(setup["video"], embs[:, :2], valid[:, :2], n_expressions=2)


def test_vos_driver_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VOSDriver(_vos_cfg(torch_tiny_config()), capacity=2)


@pytest.mark.parametrize("V,T,window", [(8, 2, 6), (30, 5, 30), (61, 5, 30), (7, 3, 3)])
def test_clip_offsets_stay_in_the_window(V, T, window):
    """At stride 1 every clip's window offset lies in [0, W - T] (W =
    out_window + T, the pool's window), so ``window_slice`` never clamps
    on the driver's path and the JAX loop's re-encodes are kept."""
    cfg = _vos_cfg(torch_tiny_config())
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, num_frames=T, num_frames_window=window))
    d = VOSDriver(cfg, capacity=2, device="cpu")
    clips = list(d._iter_clips(V))
    assert all(0 <= c["offset"] <= d.out_window for c in clips)
    assert clips[-1]["is_last"] and sum(n for c in clips for _, n in c["emits"]) == V
    # the JAX VOS loop re-encodes when i + T passes the window
    want, end = [], 0
    for c in clips:
        if c["i"] + T > end:
            want.append(c["i"])
            end = c["i"] + window
    assert [c["new_window"] for c in clips if c["new_window"] is not None] == want


def _port_loop_events(monkeypatch, driver_cls, cfg, model, V):
    """The port driver's clip loop with the model, the clip step and the
    pool moves replaced by recorders: [("encode", start), ("clip",
    offset, frame indices), ("emit", n), ("evict", n), ("shift",)]."""
    from univs_tpu_torch.inference import memory_pool as mp

    d = driver_cls(cfg, model, device="cpu")
    ev = []
    d.encode_window = lambda f, *videos: (ev.append(("encode", int(f[0, 0, 0, 0]))),
                                          (torch.zeros(d.window, 1), ()))[1]
    monkeypatch.setattr(mp, "evict_window", lambda pool, n: ev.append(("evict", n)))
    monkeypatch.setattr(mp, "shift_clip", lambda pool, s: ev.append(("shift",)))
    frames = torch.arange(V).reshape(V, 1, 1, 1)
    d._clip_loop(frames[None], [None],
                 lambda b, feats, c: ev.append(("clip", c["offset"], tuple(c["clip_idx"].tolist()))),
                 lambda b, start, n: ev.append(("emit", n)))
    return ev


def _jax_vos_loop_events(cfg, V):
    """The JAX package's ``VOSDriver.run`` loop with its jitted steps
    replaced by recorders (same event list as ``_port_loop_events``)."""
    jd = JaxVOSDriver(cfg, None, capacity=1)
    ev = []

    def encode(params, frames):
        ev.append(("encode", int(frames[0, 0, 0, 0])))
        return jnp.zeros((jd.window, 1)), ()

    def clip(params, feats, pool, gt_clip, faf, ov, frame_indices, clip_offset, cls_emb):
        ev.append(("clip", int(clip_offset), tuple(np.asarray(frame_indices).tolist())))
        return pool, None

    def emit(pool, n):
        ev.extend([("emit", n), ("evict", n)])
        return np.zeros((1, n, 1, 1), np.float32), pool

    jd._encode_window_fn, jd._clip_fn, jd._emit_fn = encode, clip, emit
    jd._shift_fn = lambda pool: (ev.append(("shift",)), pool)[1]
    frames = np.broadcast_to(np.arange(V, dtype=np.uint8)[:, None, None, None], (V, 4, 4, 3))
    jd.run(frames, np.zeros((1, V, 1, 1), np.float32), np.array([0]), np.array([True]),
           jnp.zeros((1, cfg.decoder.clip_cls_emb_dim)))
    return ev


def _jax_entity_loop_events(cfg, V):
    """The JAX package's ``EntityDriver`` schedule (its dispatch loop
    consumes ``_iter_clips``), as the same event list."""
    from univs_tpu.inference.driver import EntityDriver as JaxEntityDriver

    inf = cfg.inference
    ns = types.SimpleNamespace(T=inf.num_frames, stride=inf.clip_stride, window=inf.num_frames_window)
    ns.out_window = max(ns.window - ns.T, ns.T)
    ev = []
    for c in JaxEntityDriver._iter_clips(ns, V):
        if c["new_window"] is not None:
            ev.append(("encode", c["new_window"]))
        ev.append(("clip", c["offset"], tuple(c["clip_idx"].tolist())))
        for _, n in c["emits"]:
            ev += [("emit", n), ("evict", n)]
        if not c["is_last"]:
            ev.append(("shift",))
    return ev


@pytest.mark.parametrize("V,T,stride,window", [(8, 4, 3, 8), (13, 3, 2, 6), (3, 5, 1, 6),
                                               (8, 2, 1, 6)])
def test_clip_loops_follow_their_jax_loops(monkeypatch, V, T, stride, window):
    """Each port driver's clip loop encodes, steps, emits, evicts and
    shifts as its JAX loop does, at strides above 1 and on a video
    shorter than a clip too: the VOS loop re-encodes when ``i + T``
    passes the window, the entity loop when the clamped clip end does.
    At (8, 4, 3, 8) the two rules part (the last clip, 6..9 clamped to
    7, lies inside the window [0, 8) only when clamped)."""
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.models.univs import build_model

    def sized(cfg):
        return dataclasses.replace(cfg, inference=dataclasses.replace(
            cfg.inference, num_frames=T, clip_stride=stride, num_frames_window=window))

    jcfg, tcfg = sized(_vos_cfg(tiny_test_config())), sized(_vos_cfg(torch_tiny_config()))
    model = build_model(tcfg, None, device="cpu")
    vos = _port_loop_events(monkeypatch, VOSDriver, tcfg, model, V)
    ent = _port_loop_events(monkeypatch, EntityDriver, tcfg, model, V)
    assert vos == _jax_vos_loop_events(jcfg, V)
    assert ent == _jax_entity_loop_events(jcfg, V)
    encodes = lambda ev: [e for e in ev if e[0] == "encode"]  # noqa: E731
    assert (encodes(vos) != encodes(ent)) == ((V, T, stride, window) == (8, 4, 3, 8))
