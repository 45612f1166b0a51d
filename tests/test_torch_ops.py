"""Parity of the port's small ops on the entity path against the JAX
package on the CPU: the 3-D sine position encodings (grid2d, FixedT,
ArbitraryT, points), the mask / box utilities, the mask-prompt sampler
(integer and non-integer mask-to-grid ratios) and the RLE encoder.
Float outputs at 1e-5 relative to their largest magnitude; boolean,
index and RLE outputs exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.ops import mask_ops as jops
from univs_tpu.ops.position_encoding import SinePositionEncoding3D as JaxPE
from univs_tpu.prompts.visual_prompt import sample_visual_prompts as jax_sample
from univs_tpu.utils import rle as jax_rle
from univs_tpu_torch.ops import mask_ops as tops
from univs_tpu_torch.ops.position_encoding import SinePositionEncoding3D
from univs_tpu_torch.prompts.visual_prompt import sample_visual_prompts
from univs_tpu_torch.utils import rle

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("case", ["grid2d", "fixed", "arbitrary", "points"])
def test_position_encoding(case):
    mode = "fixed" if case == "fixed" else "arbitrary"
    jpe, tpe = JaxPE(num_pos_feats=16, mode=mode), SinePositionEncoding3D(num_pos_feats=16, mode=mode)
    fi = np.array([3, 4, 7])
    if case == "grid2d":
        want, got = jpe.grid2d(5, 7), tpe.grid2d(5, 7)
    elif case == "points":
        xy = np.random.RandomState(0).rand(9, 2).astype(np.float32)
        want, got = jpe.points(jnp.asarray(xy), jnp.asarray(fi)), tpe.points(torch.as_tensor(xy), torch.as_tensor(fi))
    else:
        want, got = jpe.grid(3, 5, 7, jnp.asarray(fi)), tpe.grid(3, 5, 7, torch.as_tensor(fi))
    _close(got.numpy(), want)


def _masks(seed, n, h=12, w=16):
    m = np.random.RandomState(seed).rand(n, h, w) > 0.7
    m[0] = False  # one empty mask
    return m


@pytest.mark.parametrize("op", ["masks_to_boxes", "box_iou", "box_convert", "mask_iou",
                                "pairwise_mask_iou", "nms_triu", "point_sample", "resize_up",
                                "resize_down"])
def test_mask_ops(op):
    rng = np.random.RandomState(1)
    a, b = _masks(2, 5), _masks(3, 4)
    t = torch.as_tensor
    if op == "masks_to_boxes":
        _close(tops.masks_to_boxes(t(a)).numpy(), jops.masks_to_boxes(jnp.asarray(a)))
    elif op == "box_iou":
        ba = np.sort(rng.rand(6, 2, 2), axis=1).reshape(6, 4)[:, [0, 2, 1, 3]].astype(np.float32)
        bb = np.sort(rng.rand(3, 2, 2), axis=1).reshape(3, 4)[:, [0, 2, 1, 3]].astype(np.float32)
        _close(tops.box_iou(t(ba), t(bb)).numpy(), jops.box_iou(jnp.asarray(ba), jnp.asarray(bb)))
    elif op == "box_convert":
        bx = rng.rand(7, 4).astype(np.float32)
        _close(tops.box_xyxy_to_cxcywh(t(bx)).numpy(), jops.box_xyxy_to_cxcywh(jnp.asarray(bx)))
        _close(tops.box_cxcywh_to_xyxy(t(bx)).numpy(), jops.box_cxcywh_to_xyxy(jnp.asarray(bx)))
    elif op == "mask_iou":
        fa, fb = a.astype(np.float32), b.astype(np.float32)
        _close(tops.mask_iou(t(fa), t(fb)).numpy(), jops.mask_iou(jnp.asarray(fa), jnp.asarray(fb)))
    elif op == "pairwise_mask_iou":
        _close(tops.pairwise_mask_iou(t(a), t(b)).numpy(), jops.pairwise_mask_iou(jnp.asarray(a), jnp.asarray(b)))
    elif op == "nms_triu":
        iou = rng.rand(8, 8).astype(np.float32)
        iou = (iou + iou.T) / 2
        scores = np.round(rng.rand(8), 1).astype(np.float32)  # ties
        valid = rng.rand(8) > 0.2
        got = tops.nms_triu_keep_from_iou(t(iou), t(scores), 0.6, t(valid)).numpy()
        want = jops.nms_triu_keep_from_iou(jnp.asarray(iou), jnp.asarray(scores), 0.6, jnp.asarray(valid))
        np.testing.assert_array_equal(got, np.asarray(want))
    elif op == "point_sample":
        feats = rng.randn(3, 6, 9).astype(np.float32)
        coords = (rng.rand(11, 2) * 1.2 - 0.1).astype(np.float32)
        _close(tops.point_sample(t(feats), t(coords)).numpy(), jops.point_sample(jnp.asarray(feats), jnp.asarray(coords)))
    else:
        x = rng.randn(2, 3, 6, 9).astype(np.float32)
        hw = (13, 20) if op == "resize_up" else (4, 5)
        _close(tops.resize_bilinear(t(x), hw).numpy(), jops.resize_bilinear(jnp.asarray(x), hw))


@pytest.mark.parametrize("mask_hw", [(16, 24), (13, 19)])
def test_mask_prompt_sampler(mask_hw):
    """The mask-only path the pool re-encode takes; (13, 19) -> (4, 6) is a
    non-integer ratio (JAX's half-pixel nearest, not torch's floor)."""
    rng = np.random.RandomState(4)
    H, W, C, Qp, R = 4, 6, 8, 5, 6
    feats = rng.randn(H, W, C).astype(np.float32)
    pos = rng.randn(H, W, C).astype(np.float32)
    masks = (rng.rand(Qp, *mask_hw) > 0.8).astype(np.float32)
    masks[1] = 0.0
    occur = np.array([True, True, False, True, True])
    want = jax_sample(jnp.asarray(feats), jnp.asarray(pos), jnp.asarray(masks), jnp.zeros((Qp, 4)),
                      jnp.asarray(occur), jnp.full((Qp,), 2), R, mask_only=True)
    got = sample_visual_prompts(torch.as_tensor(feats), torch.as_tensor(pos), torch.as_tensor(masks),
                                torch.as_tensor(occur), R)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.kv_valid.numpy(), np.asarray(want.kv_valid))
    _close(got.kv.numpy(), want.kv)
    _close(got.kv_pe.numpy(), want.kv_pe)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 96)])
def test_rle_matches_jax_package(shape):
    rng = np.random.RandomState(shape[0])
    for density in (0.0, 0.3, 1.0):
        m = (rng.rand(*shape) < density).astype(np.uint8)
        assert rle.encode(m) == jax_rle.encode(m)
        np.testing.assert_array_equal(rle.decode(rle.encode(m)), m)
