"""Prompt-guided clip-step parity of the PyTorch port against the JAX
package on the CPU, tiny config: the GT injection, the overlap
resolution and paired IoU, both learnable-query re-ID laws (box-IoU
top-k with tied IoUs; Hungarian on weighted cosine or bisoftmax
similarity), ``vos_clip_step`` over two clips in each query mode and for
grounding with and without the previous clip's visual prompts, and the
decoder's grounding task with the l4p fusion.

Pool fields must match to 1e-4 of each field's largest magnitude, and
the clip's decisions exactly: which first-appear objects are written
(``first_ok``), which appeared objects accumulate (``gated``) and which
match a learnable query (``cons_l``).  The JAX step returns none of
these, so they are read from the values its helpers were called with
and returned (the helpers are wrapped for the trace).  Each decision is
asserted to be taken for at least one object, so the random weights do
not make the comparison vacuous."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univs_tpu.inference.vos as jvos
from univs_tpu.config import tiny_test_config
from univs_tpu.inference import memory_pool as jmp
from univs_tpu.inference.entity import EntityClipConfig as JaxClipConfig
from univs_tpu.models.univs import UniVSModel, build_decoder, build_pixel_decoder
from univs_tpu.structures import TextPrompts as JaxTextPrompts
from univs_tpu.structures import VisualPrompts as JaxVisualPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference import memory_pool as tmp
from univs_tpu_torch.inference import vos as tvos
from univs_tpu_torch.inference.entity import EntityClipConfig
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.structures import TextPrompts, VisualPrompts
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

T, H, W, K = 2, 64, 96, 5
N, R = 4, 8
H4, W4 = H // 4, W // 4


def _pools_equal(tp, jp, rel=1e-4):
    for f in dataclasses.fields(tp):
        if f.name == "window_start":
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
    kw = {f.name: torch.tensor(np.array(getattr(jp, f.name)))
          for f in dataclasses.fields(tmp.EntityMemory) if f.name != "window_start"}
    return tmp.EntityMemory(window_start=int(jp.window_start), **kw)


def _jax_pool(n=N, window=6):
    return jmp.create_entity_memory(n, K, tiny_test_config().decoder.hidden_dim, (H4, W4),
                                    window=window, num_prompt_points=R, embd_history=4,
                                    prompt_history=4)


def _gt(faf, seed=1):
    """[N, 3 frames, H4, W4] seeded ellipses at each object's first frame."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((len(faf), 3, H4, W4), np.float32)
    yy, xx = np.mgrid[0:H4, 0:W4]
    for n, f in enumerate(faf):
        cy, cx = rng.uniform(0.25, 0.75) * H4, rng.uniform(0.25, 0.75) * W4
        ry, rx = rng.uniform(0.2, 0.35) * H4, rng.uniform(0.2, 0.35) * W4
        if 0 <= f < 3:
            gt[n, f] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return gt


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    jm = UniVSModel(cfg)
    rng = np.random.RandomState(0)
    images = rng.rand(1, T + 1, H, W, 3).astype(np.float32) * 255
    cls_emb = rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = JaxTextPrompts(embs=jnp.asarray(cls_emb)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                             text_prompts=tp, cls_emb=jnp.asarray(cls_emb)))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), images[:, :T],
                                           jnp.arange(T)[None])["params"])
    modules = (build_pixel_decoder(cfg), build_decoder(cfg))
    bb = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=lambda m, y: m.backbone(m.normalize(y))))(
        params, images.reshape(T + 1, H, W, 3))
    mf, _, _, ms = jax.jit(lambda p, f: modules[0].apply({"params": p}, f))(params["pixel_decoder"], bb)
    feats = (np.array(mf), tuple(np.array(m) for m in ms))  # 3 frames; a clip slices T
    text = rng.randn(1, N, 1 + 6, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
    text[:, N - 1] = 0.0  # a pad row
    text_valid = np.arange(N)[None] < N - 1
    tm = build_model(torch_tiny_config(), state_dict_from_flax(params), device="cpu")
    return dict(cfg=cfg, params=params, modules=modules, feats=feats, cls_emb=cls_emb, tm=tm,
                text=text, text_valid=text_valid)


def _clip_feats(feats, frames):
    mf, ms = feats
    return mf[frames], tuple(m[frames] for m in ms)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip_offset", [0, 3, 5])
def test_inject_gt_matches_jax(clip_offset):
    """Objects first appearing inside, before, after the clip and never;
    an invalid object; a pool that already holds logits; offset 5 is past
    the window's last start (4) and reads the clamped slice."""
    faf = np.array([3, 4, 1, -1, 3, 5])
    ov = np.array([True, True, True, True, False, True])
    rng = np.random.RandomState(clip_offset)
    jp = _jax_pool(n=6).replace(
        mask_logits=jnp.asarray(rng.randn(6, 6, H4, W4).astype(np.float32)),
        first_appear=jnp.asarray([-1, -1, 1, -1, -1, 2], jnp.int32))
    tp = _torch_pool(jp)
    gt = (rng.rand(6, T, H4, W4) > 0.5).astype(np.float32)
    frames = np.array([3, 4])
    jp = jvos.inject_gt_first_appearance(jp, jnp.asarray(gt), jnp.asarray(faf), jnp.asarray(ov),
                                         jnp.asarray(frames), jnp.int32(clip_offset))
    tvos.inject_gt_first_appearance(tp, torch.as_tensor(gt), torch.as_tensor(faf, dtype=torch.int32),
                                    torch.as_tensor(ov), frames, clip_offset)
    _pools_equal(tp, jp, rel=0.0)


def test_window_slice_is_dynamic_slice():
    """Every clip offset is >= 0 (i >= frames emitted); past W - t the
    start is clamped."""
    x = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    for off in range(0, 10):
        want = jax.lax.dynamic_slice_in_dim(jnp.asarray(x), off, 3, axis=1)
        np.testing.assert_array_equal(tmp.window_slice(torch.as_tensor(x), off, 3).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_overlap_resolve_and_pair_iou_match_jax(seed):
    rng = np.random.RandomState(seed)
    masks = (rng.randn(5, T, H4, W4) * 3).astype(np.float32)
    masks[1] = masks[0]  # identical masks: the argmax's tie order decides
    weights = rng.rand(5).astype(np.float32)
    weights[1] = weights[0]
    weights[3] = 0.0
    active = np.array([True, True, False, True, True])
    want = jvos._overlap_resolve(jnp.asarray(masks), jnp.asarray(weights), jnp.asarray(active))
    got = tvos._overlap_resolve(torch.as_tensor(masks), torch.as_tensor(weights),
                                torch.as_tensor(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1] == 0).all() and (got[0] != 0).any(), "ties go to the lower index"
    a, b = masks[:, 0] > 0, masks[:, 1] > 0.5
    a[2] = b[2] = False  # an empty pair: IoU 0
    np.testing.assert_array_equal(tvos._pair_mask_iou(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                                  np.asarray(jvos._pair_mask_iou(jnp.asarray(a), jnp.asarray(b))))


def test_match_learn_first_appear_with_tied_box_ious():
    Q = 8
    masks_l = np.full((Q, T, H4, W4), -10.0, np.float32)
    gt = np.zeros((3, H4, W4), np.float32)
    gt[0, 2:8, 2:10] = 1
    gt[1, 9:14, 12:20] = 1
    gt[2, 13:16, 20:24] = 1  # no query overlaps it: every box IoU is 0
    masks_l[6, 0, 2:8, 2:10] = 10.0  # queries 6 and 3: the same mask, the same IoUs
    masks_l[3, 0, 2:8, 2:10] = 10.0
    masks_l[1, 0, 2:9, 2:12] = 10.0
    masks_l[5, 1, 9:14, 12:20] = 10.0
    masks_l[2, 1, 10:14, 12:18] = 10.0
    faf_local = np.array([0, 1, 0])
    for topk in (1, 3, 5):
        want = jvos.match_learn_first_appear(jnp.asarray(masks_l), jnp.asarray(gt),
                                             jnp.asarray(faf_local), topk=topk)
        got = tvos.match_learn_first_appear(torch.as_tensor(masks_l), torch.as_tensor(gt),
                                            torch.as_tensor(faf_local), topk=topk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.tolist() == [3, 5, 0], topk


@pytest.mark.parametrize("use_norm", [True, False])
def test_match_learn_appeared_matches_jax(use_norm):
    Q, C = 8, 16
    rng = np.random.RandomState(3)
    embds = rng.randn(N, 4, C).astype(np.float32)
    embds[:, :2] = 0.0  # blank history frames
    embds[2, 2] = 0.0
    cur = rng.randn(Q, T, C).astype(np.float32)
    cur[5] = embds[0, -1]
    cur[2] = embds[1, -1] * 2.0
    cur[7] = cur[6]  # two identical candidates: the Hungarian's tie order
    jp = jmp.create_entity_memory(N, K, C, (2, 3), window=4, num_prompt_points=4,
                                  embd_history=4, prompt_history=4)
    jp = jp.replace(embds=jnp.asarray(embds), valid=jnp.asarray([True, True, True, False]))
    j_s2c, j_sim = jvos.match_learn_appeared(jp, jnp.asarray(cur), num_prev=3, use_norm=use_norm)
    t_s2c, t_sim = tvos.match_learn_appeared(_torch_pool(jp), torch.as_tensor(cur), num_prev=3,
                                             use_norm=use_norm)
    np.testing.assert_array_equal(t_s2c.numpy(), np.asarray(j_s2c))
    np.testing.assert_allclose(t_sim.numpy(), np.asarray(j_sim), rtol=1e-5, atol=1e-6)
    assert int(t_s2c[3]) == -1 and float(t_sim[3]) == 0.0


# ---------------------------------------------------------------------------
# the clip step
# ---------------------------------------------------------------------------


def _jax_step(setup, monkeypatch, pool, frames, offset, cc, **kw):
    """The JAX clip step, jitted, with the values its helpers were called
    with and returned -> (pool, decisions dict of numpy bool [N])."""
    cap = {"resolve": [], "iou": [], "learn": []}

    def spy(name, fn, keep):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            cap[name].append(keep(args, out))
            return out
        return wrapped

    monkeypatch.setattr(jvos, "_overlap_resolve", spy(
        "resolve", jvos._overlap_resolve, lambda a, o: (a[0], a[2], o)))
    monkeypatch.setattr(jvos, "_pair_mask_iou", spy(
        "iou", jvos._pair_mask_iou, lambda a, o: (a[0], o)))
    monkeypatch.setattr(jvos, "match_learn_appeared", spy(
        "learn", jvos.match_learn_appeared, lambda a, o: o[1]))

    def fn(params, feats, pool, fi, off, cls_emb):
        for v in cap.values():
            v.clear()
        pool, _ = jvos.vos_clip_step(setup["modules"], params, feats, pool, fi, off, cls_emb, cc,
                                     **kw)
        return pool, cap["resolve"], cap["iou"], cap["learn"]

    feats = _clip_feats(setup["feats"], frames)
    pool, res, ious, learn = jax.jit(fn)(setup["params"], feats, pool, jnp.asarray(frames),
                                         jnp.int32(offset), jnp.asarray(setup["cls_emb"]))
    (_, first_active, _), (masks_app, gated_pre, resolved_app) = [
        tuple(np.asarray(x) for x in r) for r in res]
    gt_at_faf, miou2 = np.asarray(ious[1][0]), np.asarray(ious[1][1])
    area = np.clip(gt_at_faf.sum((-2, -1)).astype(np.float32) / np.float32(96.0 * 96.0), 0, 1)
    grounding = kw.get("task") == "grounding"
    first_ok = first_active & (grounding | (miou2 > np.float32(0.15) * area))
    ratio = ((resolved_app > 0).sum((-3, -2, -1)) / np.maximum((masks_app > 0).sum((-3, -2, -1)), 1))
    dec = {"first_ok": first_ok, "gated": gated_pre & (ratio.astype(np.float32) > 0.25)}
    if learn:
        dec["cons_l"] = np.asarray(learn[0]) >= 0.65
    return pool, dec


def _torch_step(setup, pool, frames, offset, cc, **kw):
    tm = setup["tm"]
    mf, ms = _clip_feats(setup["feats"], frames)
    feats = (torch.as_tensor(mf), tuple(torch.as_tensor(m) for m in ms))
    with torch.no_grad():
        _, aux = tvos.vos_clip_step((tm.pixel_decoder, tm.decoder), feats, pool, frames, offset,
                                    torch.as_tensor(setup["cls_emb"]), cc, **kw)
    return {k: v.numpy() for k, v in aux.items() if k in ("first_ok", "gated", "cons_l")
            and v is not None}


def _configs(cfg, **kw):
    kw = dict(num_queries=cfg.decoder.num_queries, num_prev_frames_memory=3,
              num_dense_points=R, clip_stride=1, num_frames=T, **kw)
    return JaxClipConfig(**kw), EntityClipConfig(**kw)


@pytest.mark.parametrize("query_mode", ["prompt", "learn", "prompt+learn"])
def test_vos_clip_steps_match_jax(setup, monkeypatch, query_mode):
    """Two clips: objects 0 and 1 appear at frame 0, object 2 at frame 2
    (injected in the second clip), object 3 never."""
    jcc, tcc = _configs(setup["cfg"])
    faf = np.array([0, 0, 2, -1])
    ov = np.ones(N, bool)
    gt = _gt(faf)
    jpool = _jax_pool()
    tpool = _torch_pool(jpool)
    seen = {"first_ok": False, "gated": False, "cons_l": False}
    for step, (frames, offset) in enumerate([(np.array([0, 1]), 0), (np.array([1, 2]), 1)]):
        if step:
            jpool = jmp.shift_clip(jpool, 1)
            tmp.shift_clip(tpool, 1)
        jpool = jvos.inject_gt_first_appearance(
            jpool, jnp.asarray(gt[:, frames]), jnp.asarray(faf), jnp.asarray(ov),
            jnp.asarray(frames), jnp.int32(offset))
        tvos.inject_gt_first_appearance(tpool, torch.as_tensor(gt[:, frames]),
                                        torch.as_tensor(faf, dtype=torch.int32),
                                        torch.as_tensor(ov), frames, offset)
        jpool, want = _jax_step(setup, monkeypatch, jpool, frames, offset, jcc,
                                query_mode=query_mode)
        got = _torch_step(setup, tpool, frames, offset, tcc, query_mode=query_mode)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"clip {step}: {k}")
            seen[k] |= bool(want[k].any())
        _pools_equal(tpool, jpool)
    assert seen["first_ok"] and seen["gated"], seen
    if query_mode != "prompt":
        assert seen["cons_l"], "a pool object must match a learnable query"


@pytest.mark.parametrize("prev_visual", [False, True])
def test_grounding_clip_steps_match_jax(setup, monkeypatch, prev_visual):
    """Three expressions (a pad row) over two clips; with the previous
    clip's visual prompts on, the first clip's visual kv is all zeros and
    the second's is re-encoded from the first clip's masks."""
    jcc, tcc = _configs(setup["cfg"], prev_visual_prompts_for_grounding=prev_visual)
    n = int(setup["text_valid"].sum())
    jpool = _jax_pool()
    jpool = jpool.replace(valid=jnp.arange(N) < n,
                          first_appear=jnp.where(jnp.arange(N) < n, 0, -1).astype(jnp.int32))
    tpool = _torch_pool(jpool)
    jtp = JaxTextPrompts(embs=jnp.asarray(setup["text"]), valid=jnp.asarray(setup["text_valid"]))
    ttp = TextPrompts(embs=torch.as_tensor(setup["text"]), valid=torch.as_tensor(setup["text_valid"]))
    seen = {"first_ok": False, "gated": False}
    for step, (frames, offset) in enumerate([(np.array([0, 1]), 0), (np.array([1, 2]), 1)]):
        if step:
            jpool = jmp.shift_clip(jpool, 1)
            tmp.shift_clip(tpool, 1)
        jpool, want = _jax_step(setup, monkeypatch, jpool, frames, offset, jcc,
                                text_prompts=jtp, task="grounding")
        got = _torch_step(setup, tpool, frames, offset, tcc, text_prompts=ttp, task="grounding")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"clip {step}: {k}")
            seen[k] |= bool(want[k].any())
        _pools_equal(tpool, jpool)
    assert seen["first_ok"] and seen["gated"], seen
    if prev_visual:
        assert bool(tpool.prompt_valid.any()), "the second clip reads a committed visual kv"


# ---------------------------------------------------------------------------
# the decoder's grounding task
# ---------------------------------------------------------------------------


def test_decoder_grounding_matches_jax(setup):
    """task='grounding' with text prompts, with and without a
    singleton-frame visual kv concatenated ahead, l4p fusion on and off:
    logits, masks and embeddings to 1e-4.  The fusion moves the prompt
    queries' masks, and through the next layer's attention mask every
    later layer's outputs."""
    rng = np.random.RandomState(5)
    C, L = setup["cfg"].decoder.hidden_dim, 3
    vkv = rng.randn(1, N, L, 1, C).astype(np.float32)
    vkv_valid = rng.rand(1, N, L, 1) > 0.3
    zq = np.zeros((1, N, T, C), np.float32)
    mf, ms = _clip_feats(setup["feats"], np.arange(T))
    fi = np.arange(T)[None]
    tdec = setup["tm"].decoder
    ttp = TextPrompts(embs=torch.as_tensor(setup["text"]), valid=torch.as_tensor(setup["text_valid"]))
    outs = {}
    try:
        for l4p in (True, False):
            cfg = setup["cfg"]
            jdec = build_decoder(dataclasses.replace(
                cfg, decoder=dataclasses.replace(cfg.decoder, l4p_fusion=l4p)))
            tdec.l4p_fusion = l4p
            apply = jax.jit(lambda p, ms_, mf_, fi_, te, tv, vp: jdec.apply(
                {"params": p}, ms_, mf_, fi_, task="grounding",
                text_prompts=JaxTextPrompts(embs=te, valid=tv), visual_prompts=vp))
            for with_visual in (False, True):
                jvp = tvp = None
                if with_visual:
                    jvp = JaxVisualPrompts(queries=jnp.asarray(zq), query_pos=jnp.asarray(zq),
                                           kv=jnp.asarray(vkv), kv_pe=None,
                                           kv_valid=jnp.asarray(vkv_valid),
                                           valid=jnp.asarray(setup["text_valid"]))
                    tvp = VisualPrompts(queries=torch.as_tensor(zq), query_pos=torch.as_tensor(zq),
                                        kv=torch.as_tensor(vkv), kv_pe=None,
                                        kv_valid=torch.as_tensor(vkv_valid),
                                        valid=torch.as_tensor(setup["text_valid"]))
                want = apply(setup["params"]["decoder"], ms, mf, fi, setup["text"],
                             setup["text_valid"], jvp)
                with torch.no_grad():
                    got = tdec([torch.as_tensor(m) for m in ms], torch.as_tensor(mf),
                               torch.as_tensor(fi), task="grounding", visual_prompts=tvp,
                               text_prompts=ttp)
                for key in ("pred_logits", "pred_masks", "pred_embds"):
                    w, g = np.asarray(want[key]), got[key].numpy()
                    assert g.shape == w.shape, key
                    err = float(np.abs(g - w).max())
                    assert err <= 1e-4 * max(float(np.abs(w).max()), 1.0), (key, l4p, with_visual)
                assert got["pred_logits"].shape[-1] == N
                outs[l4p, with_visual] = got
    finally:
        tdec.l4p_fusion = True
    Ql = setup["cfg"].decoder.num_queries
    for with_visual in (False, True):
        on, off = outs[True, with_visual], outs[False, with_visual]
        assert not np.allclose(on["pred_masks"][:, Ql:], off["pred_masks"][:, Ql:])
        assert not np.allclose(on["pred_embds"], off["pred_embds"]), "the allow-mask mirrors it"
    assert not np.allclose(outs[True, False]["pred_masks"], outs[True, True]["pred_masks"]), \
        "the visual kv changes the decode"


def test_decoder_detection_with_text_prompts_matches_jax(setup):
    """task='detection' with category text prompts [B, K, 1, Dt] takes
    the same text branch (prompt_detection, no l4p): logits, masks and
    embeddings to 1e-4."""
    K_, Dt = 3, setup["cfg"].decoder.clip_cls_emb_dim
    emb = np.random.RandomState(6).randn(1, K_, 1, Dt).astype(np.float32)
    valid = np.ones((1, K_), bool)
    mf, ms = _clip_feats(setup["feats"], np.arange(T))
    fi = np.arange(T)[None]
    jdec = build_decoder(setup["cfg"])
    want = jax.jit(lambda p, ms_, mf_, fi_, te, tv, ce: jdec.apply(
        {"params": p}, ms_, mf_, fi_, task="detection",
        text_prompts=JaxTextPrompts(embs=te, valid=tv), cls_emb=ce))(
        setup["params"]["decoder"], ms, mf, fi, emb, valid, setup["cls_emb"])
    with torch.no_grad():
        got = setup["tm"].decoder([torch.as_tensor(m) for m in ms], torch.as_tensor(mf),
                                  torch.as_tensor(fi), task="detection",
                                  text_prompts=TextPrompts(embs=torch.as_tensor(emb),
                                                           valid=torch.as_tensor(valid)),
                                  cls_emb=torch.as_tensor(setup["cls_emb"]))
    Ql = setup["cfg"].decoder.num_queries
    assert got["pred_masks"].shape[1] == Ql + K_
    for key in ("pred_logits", "pred_masks", "pred_embds"):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        assert float(np.abs(g - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1.0), key
