"""Parity of the port's image generic segmentation against the JAX
package's on the CPU: the three numpy laws (``instance_inference``,
``semantic_inference``, ``panoptic_inference``) and their helpers on
seeded inputs with tied boxes and empty masks, and ``ImageDriver.run``
on the tiny config with the same weights (bridged by
``state_dict_from_flax``), padded frame, cropped and resized output; the
laws then give the same decisions on both drivers' outputs.  Scores
within 1e-5, logits within 1e-4 of their largest magnitude, decisions
(kept results, categories, binary masks, panoptic maps, segments)
identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import tiny_test_config
from univs_tpu.inference import image as jimg
from univs_tpu.models.univs import UniVSModel
from univs_tpu.structures import TextPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.inference import image as timg
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

H, W, K = 64, 96, 5


def _laws_inputs(seed, q, k, hw):
    rng = np.random.RandomState(seed)
    cls = rng.rand(q, k).astype(np.float32)
    masks = (rng.randn(q, *hw) * 4).astype(np.float32)
    masks[1] = -5.0  # an empty mask: the all-zero box
    masks[2] = masks[3]  # a duplicate: tied boxes and scores
    cls[2] = cls[3]
    return cls, masks


def _same_instances(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["category_id"] == w["category_id"]
        assert abs(g["score"] - w["score"]) <= 1e-5
        assert np.array_equal(g["mask"], w["mask"])


def _same_panoptic(got, want):
    assert got[1] == want[1]
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("seed,things,paq", [(0, None, True), (1, [0, 2], True), (2, [1], False),
                                             (3, [0, 1, 2, 3, 4], True)])
def test_instance_law_matches_jax(seed, things, paq):
    cls, masks = _laws_inputs(seed, 9, K, (20, 24))
    args = dict(num_queries=5, thing_contiguous_ids=things, topk=7, prompt_as_queries=paq)
    _same_instances(timg.instance_inference(cls, masks, **args),
                    jimg.instance_inference(cls, masks, **args))


@pytest.mark.parametrize("seed,disable,paq", [(0, False, True), (1, True, True), (2, False, False)])
def test_semantic_law_matches_jax(seed, disable, paq):
    cls, masks = _laws_inputs(seed, 9, K, (20, 24))
    args = dict(num_queries=5, disable_semantic_queries=disable, prompt_as_queries=paq, topk=6)
    got = timg.semantic_inference(cls, masks, **args)
    want = jimg.semantic_inference(cls, masks, **args)
    assert got.shape == (K, 20, 24) and np.array_equal(got, want)


@pytest.mark.parametrize("seed,things,thr", [(0, {0, 2}, 0.05), (1, {1}, 0.3), (2, set(), 0.05)])
def test_panoptic_law_matches_jax(seed, things, thr):
    cls, masks = _laws_inputs(seed, 9, K, (20, 24))
    args = dict(num_queries=5, thing_contiguous_ids=things, object_mask_threshold=thr)
    _same_panoptic(timg.panoptic_inference(cls, masks, **args),
                   jimg.panoptic_inference(cls, masks, **args))


def test_box_and_nms_helpers_match_jax():
    cls, masks = _laws_inputs(4, 9, K, (20, 24))
    boxes = timg.masks_to_boxes_np(masks > 0)
    assert np.array_equal(boxes, jimg.masks_to_boxes_np(masks > 0)) and not boxes[1].any()
    s, labels = cls.max(-1), cls.argmax(-1)
    assert np.array_equal(timg.batched_nms_np(boxes, s, labels, 0.5),
                          jimg.batched_nms_np(boxes, s, labels, 0.5))
    assert np.array_equal(timg.mask_quality_scores_np(masks), jimg.mask_quality_scores_np(masks))


@pytest.fixture(scope="module")
def drivers():
    jcfg = tiny_test_config()
    jm = UniVSModel(jcfg)
    rng = np.random.RandomState(0)
    bank = rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = TextPrompts(embs=jnp.asarray(bank)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                             text_prompts=tp, cls_emb=jnp.asarray(bank)))
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)), jnp.arange(2)[None])["params"]
    params = jax.tree.map(np.asarray, params)
    jd = jimg.ImageDriver(jcfg, params, num_classes=K)
    td = timg.ImageDriver(torch_tiny_config(), state_dict_from_flax(params), num_classes=K,
                          device="cpu")
    frame = np.zeros((1, H, W, 3), np.float32)
    frame[:, :58, :90] = rng.rand(1, 58, 90, 3) * 255  # padded past a 58 x 90 image
    return jd, td, bank, frame


@pytest.mark.parametrize("image_size,out_size", [((58, 90), (116, 180)), ((64, 96), (64, 96))])
def test_image_driver_matches_jax(drivers, image_size, out_size):
    jd, td, bank, frame = drivers
    want_cls, want_pred = jd.run(frame, jnp.asarray(bank), image_size, out_size)
    got_cls, got_pred = td.run(frame, torch.as_tensor(bank), image_size, out_size)
    Q = td.num_queries + K
    assert got_cls.shape == want_cls.shape == (Q, K)
    assert got_pred.shape == want_pred.shape == (Q, *out_size)
    np.testing.assert_allclose(got_cls, want_cls, rtol=0, atol=1e-5)
    scale = float(np.abs(want_pred).max())
    assert float(np.abs(got_pred - want_pred).max()) <= 1e-4 * scale
    assert np.array_equal(got_pred > 0, want_pred > 0)
    # the laws on each driver's own output decide the same
    nq = td.num_queries
    want_inst = jimg.instance_inference(want_cls, want_pred, nq, [0, 2, 3])
    _same_instances(timg.instance_inference(got_cls, got_pred, nq, [0, 2, 3]), want_inst)
    want_pan = jimg.panoptic_inference(want_cls, want_pred, nq, {0, 2, 3})
    _same_panoptic(timg.panoptic_inference(got_cls, got_pred, nq, {0, 2, 3}), want_pan)
    assert len(want_inst) >= 1 and len(want_pan[1]) >= 1
    sem_g = timg.semantic_inference(got_cls, got_pred, nq)
    sem_w = jimg.semantic_inference(want_cls, want_pred, nq)
    np.testing.assert_allclose(sem_g, sem_w, rtol=0, atol=1e-5)
    assert np.array_equal(sem_g.argmax(0), sem_w.argmax(0))
