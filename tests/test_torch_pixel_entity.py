"""Parity of the port's VPS / VSS entity-path pieces against the JAX
package on the CPU:

- ``_detect_newly_pixel`` on the first-clip fixture of
  tests/test_pixel_entity.py:178, then a later clip (quasi-track
  matching, matched accumulation, later-clip admission), and on a
  tie-heavy first clip (130 queries, scores with many ties, the top-100
  / 70 / 30 cuts falling inside ties, more candidates than free slots);
- ``_rank_within`` with ties;
- ``_detect_newly_instance`` with ``stability_thres > 0``;
- ``vss_semantic_labels`` on the fixture of
  tests/test_emission_formulas.py:77.

Decisions (valid slots, first appearances, labels) must be identical;
float pool fields within 1e-5 of each field's largest magnitude (the same
float32 arithmetic in another order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.inference import memory_pool as jmp
from univs_tpu.inference.driver import vss_semantic_labels as jax_vss_labels
from univs_tpu.inference.entity import EntityClipConfig as JaxClipConfig
from univs_tpu.inference.entity import _detect_newly_instance as jax_newly_instance
from univs_tpu.inference.entity import _detect_newly_pixel as jax_newly_pixel
from univs_tpu.inference.entity import _rank_within as jax_rank_within
from univs_tpu_torch.inference import memory_pool as tmp
from univs_tpu_torch.inference.driver import vss_semantic_labels
from univs_tpu_torch.inference.entity import (
    EntityClipConfig,
    _detect_newly_instance,
    _detect_newly_pixel,
    _rank_within,
)

torch.set_num_threads(1)


def _pools_equal(tp, jp, rel=1e-5):
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


def _clip(rng, Ql, K, T, C, H4, W4, levels=(4.0, -4.0), p_on=0.2):
    logits = rng.rand(Ql, K).astype(np.float32)
    on = rng.rand(Ql, T, H4, W4) < p_on
    masks = np.where(on, levels[0], levels[1]).astype(np.float32)
    embds = rng.randn(Ql, T, C).astype(np.float32)
    return logits, masks, embds


def _run_pixel(jpool, tpool, clip, offset, frames, first, thing_mask, jcc, tcc):
    logits, masks, embds = clip
    jpool = jax_newly_pixel(jpool, jnp.int32(offset), jnp.asarray(frames), jnp.bool_(first),
                            jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(embds),
                            jnp.asarray(thing_mask), jcc)
    _detect_newly_pixel(tpool, offset, list(frames), first, torch.as_tensor(logits),
                        torch.as_tensor(masks), torch.as_tensor(embds),
                        torch.as_tensor(thing_mask), tcc)
    _pools_equal(tpool, jpool)
    return jpool


def test_pixel_first_and_later_clip():
    rng = np.random.RandomState(5)
    Ql, K, T, C, H4, W4 = 20, 5, 2, 8, 16, 24
    thing_mask = np.array([True, True, False, True, False])
    kw = dict(num_queries=Ql, apply_cls_thres=0.25, nms_thres=0.85, num_dense_points=4,
              num_frames=T, variant="pixel")
    jcc, tcc = JaxClipConfig(**kw), EntityClipConfig(**kw)
    jpool = jmp.create_entity_memory(Ql, K, C, (H4, W4), window=T + 2, num_prompt_points=4,
                                     embd_history=4, prompt_history=3)
    tpool = _torch_pool(jpool)
    # the fixture of tests/test_pixel_entity.py:178: blobby +-4 masks
    jpool = _run_pixel(jpool, tpool, _clip(rng, Ql, K, T, C, H4, W4, p_on=0.2), 0, np.arange(T),
                       True, thing_mask, jcc, tcc)
    assert 0 < int(np.asarray(jpool.valid).sum()) < Ql
    jpool = jmp.shift_clip(jpool, stride=1)
    tmp.shift_clip(tpool, stride=1)
    # a later clip whose embeddings are the pool's own (plus noise for
    # half of them): matches, matched accumulation, and new admissions
    logits, masks, embds = _clip(rng, Ql, K, T, C, H4, W4, p_on=0.1)
    emb_pool = np.asarray(jpool.embds[:, -1])
    embds[: Ql // 2] = 3.0 * emb_pool[: Ql // 2, None] + 0.1 * embds[: Ql // 2]
    _run_pixel(jpool, tpool, (logits, masks, embds), 1, np.arange(1, T + 1), False, thing_mask,
               jcc, tcc)
    assert float(np.abs(tpool.occurrence.numpy()).sum()) > 0


def test_pixel_first_clip_ties():
    """130 queries: 10 of quality 0 (score 0) and the rest with scores
    rounded to 0.1, so the top-100, top-70 (things) and top-30 (stuff)
    cuts fall inside ties; 24 slots for more admissible candidates."""
    rng = np.random.RandomState(8)
    Ql, K, T, C, H4, W4, E = 130, 3, 2, 8, 8, 12, 24
    logits, masks, embds = _clip(rng, Ql, K, T, C, H4, W4, p_on=0.15)
    logits = np.round(logits, 1).astype(np.float32)
    masks[:10] = -4.0  # quality 0
    thing_mask = np.array([True, False, True])
    kw = dict(num_queries=Ql, apply_cls_thres=0.0, nms_thres=0.85, num_dense_points=4,
              num_frames=T, variant="pixel")
    jpool = jmp.create_entity_memory(E, K, C, (H4, W4), window=T + 2, num_prompt_points=4,
                                     embd_history=4, prompt_history=3)
    tpool = _torch_pool(jpool)
    jpool = _run_pixel(jpool, tpool, (logits, masks, embds), 0, np.arange(T), True, thing_mask,
                       JaxClipConfig(**kw), EntityClipConfig(**kw))
    assert int(np.asarray(jpool.valid).sum()) == E  # more candidates than slots


def test_rank_within_ties():
    rng = np.random.RandomState(2)
    for _ in range(5):
        s = np.round(rng.rand(150), 1).astype(np.float32)
        s[rng.rand(150) < 0.2] = 0.0
        mask = rng.rand(150) < 0.7
        want = np.asarray(jax_rank_within(jnp.asarray(mask), jnp.asarray(s)))
        got = _rank_within(torch.as_tensor(mask), torch.as_tensor(s)).numpy()
        np.testing.assert_array_equal(got, want)


def test_instance_stability_gate():
    """``stability_thres > 0`` gates candidates by mask quality before the
    top-k (JAX entity.py:235): the same pool as the JAX package."""
    rng = np.random.RandomState(11)
    Ql, K, T, C, H4, W4, E = 24, 4, 2, 8, 12, 16, 8
    logits = rng.rand(Ql, K).astype(np.float32)
    # a 3x4 box of +4 logits per query at its own place (box NMS keeps
    # most), and a random share of -0.5 pixels, which count in the
    # quality's denominator only: qualities spread over (0, 1]
    masks = np.full((Ql, T, H4, W4), -4.0, np.float32)
    weak = rng.rand(Ql, T, H4, W4) < rng.rand(Ql, 1, 1, 1) * 0.5
    masks[weak] = -0.5
    for q in range(Ql):
        y0, x0 = rng.randint(0, H4 - 3), rng.randint(0, W4 - 4)
        masks[q, :, y0:y0 + 3, x0:x0 + 4] = 4.0
    embds = rng.randn(Ql, T, C).astype(np.float32)
    kw = dict(num_queries=Ql, topk_candidates=10, apply_cls_thres=0.0, num_dense_points=4,
              num_frames=T, stability_thres=0.5)
    jpool = jmp.create_entity_memory(E, K, C, (H4, W4), window=T + 2, num_prompt_points=4,
                                     embd_history=4, prompt_history=3)
    tpool = _torch_pool(jpool)
    jpool = jax_newly_instance(jpool, jnp.int32(0), jnp.arange(T), jnp.bool_(True),
                               jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(embds),
                               JaxClipConfig(**kw))
    _detect_newly_instance(tpool, 0, list(range(T)), True, torch.as_tensor(logits),
                           torch.as_tensor(masks), torch.as_tensor(embds), EntityClipConfig(**kw))
    _pools_equal(tpool, jpool)
    n = int(np.asarray(jpool.valid).sum())
    # the gate binds: without it more candidates are admitted
    ungated = _torch_pool(jmp.create_entity_memory(E, K, C, (H4, W4), window=T + 2,
                                                   num_prompt_points=4, embd_history=4,
                                                   prompt_history=3))
    _detect_newly_instance(ungated, 0, list(range(T)), True, torch.as_tensor(logits),
                           torch.as_tensor(masks), torch.as_tensor(embds),
                           EntityClipConfig(**dict(kw, stability_thres=0.0)))
    assert 0 < n < int(ungated.valid.sum())


@pytest.mark.parametrize("seed", [3, 4])
def test_vss_semantic_labels_identical(seed):
    """tests/test_emission_formulas.py:77's fixture (padded 32x48, image
    29x43): the same label map as the JAX package's law."""
    rng = np.random.RandomState(seed)
    Q, K, T, h4, w4 = 6, 4, 3, 8, 12
    H, W = 4 * h4, 4 * w4
    ih, iw = H - 3, W - 5
    logits = rng.randn(Q, K).astype(np.float32) * 2
    masks = rng.randn(Q, T, h4, w4).astype(np.float32) * 3
    want = np.asarray(jax_vss_labels(jnp.asarray(logits), jnp.asarray(masks), (H, W), (ih, iw)))
    got = vss_semantic_labels(torch.as_tensor(logits), torch.as_tensor(masks), (H, W),
                              (ih, iw)).numpy()
    assert got.dtype == np.int32 and got.shape == (T, ih, iw)
    np.testing.assert_array_equal(got, want)
