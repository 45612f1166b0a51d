"""The comparison's own arithmetic on the CPU: the drain check on
synthetic windows, the rows a ratio reads, and the reference's train
step in the compute dtype over float32 masters (the training witness)."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import compare, configs, inputs, weights
from benchmark.reference.univs import UniVSModel, _upsample_threshold, build_reference
from benchmark.tests.tiny import tiny_model

SEED = 2 ** 31 + 777


def _drain(valid_slot=1):
    """Windows of 3 slots over a 5-frame video, one slot valid, and the
    results the program's drain makes of them."""
    from univs_tpu_torch.utils import rle

    g = torch.Generator().manual_seed(0)
    wins = [torch.randn((3, 3, 4, 6), generator=g).half(), torch.randn((3, 2, 4, 6), generator=g).half()]
    valid = torch.zeros(3, dtype=torch.bool)
    valid[valid_slot] = True
    size = (8, 12)
    frames = [_upsample_threshold(w[valid_slot][None], size, size, size)[0].numpy() for w in wins]
    masks = np.concatenate(frames)[:5].astype(np.uint8)
    out = [{"obj_id": valid_slot, "segmentations": [rle.encode(m) for m in masks]}]
    return {0: {"emitted": wins, "starts": [0, 3], "valid": valid, "V": 5}}, {0: out}, masks, size


def test_drain_diff_is_zero_when_sound_and_counts_what_differs():
    from univs_tpu_torch.utils import rle

    drains, outputs, masks, size = _drain()
    assert compare.drain_diff(drains, outputs, size) == 0
    bad = masks.copy()
    bad[2, 3, 4] ^= 1
    outputs[0][0]["segmentations"][2] = rle.encode(bad[2])
    assert compare.drain_diff(drains, outputs, size) == 1
    outputs[0].append({"obj_id": 2, "segmentations": outputs[0][0]["segmentations"]})
    assert compare.drain_diff(drains, outputs, size) == 2
    assert compare.drain_diff(drains, {}, size) == float("inf")


def test_ratios_read_the_rows_asked_for():
    ref = {"a": {"x": torch.ones(4, 3)}}
    low = {"a": {"x": torch.ones(4, 3) * 1.001}}
    side = {"a": {"x": torch.cat([torch.ones(2, 3) * 1.001, torch.ones(2, 3) * 1.1])}}
    names = (("x", "x"),)
    assert compare.ratios(side, ref, low, ["a"], names, rows=slice(0, 2))["x_ratio"] == \
        pytest.approx(1.0, rel=1e-3)
    got = compare.ratios(side, ref, low, ["a"], names, rows=slice(2, None), prefix="p_")
    assert got["p_x_ratio"] == pytest.approx(100.0, rel=1e-2)


def test_train_steps_in_the_compute_dtype_keep_float32_masters():
    """Two steps of the tiny reference in bfloat16 over float32 masters
    follow the float32 steps to bf16's rounding, and the model's weights
    stay the masters rounded."""
    from benchmark.reference.train import train_numbers, train_steps
    from benchmark.reference.utils.draws import make_key

    torch.manual_seed(0)
    tree = tiny_model("bfloat16")
    rcfg = configs.reference_config(tree)
    rcfg = rcfg.replace(backbone=dataclasses.replace(rcfg.backbone, swin_use_checkpoint=True),
                        decoder=dataclasses.replace(rcfg.decoder, remat_heads=True))
    with torch.device("meta"):
        shapes = UniVSModel(rcfg)
    state = weights.seeded_state(shapes, SEED, "cpu", torch.bfloat16)
    traffic = {"clips": 2, "frames": 2, "height": 64, "width": 64, "slots": 6, "objects": 2,
               "blobs": 3, "batches": 2}
    batches = inputs.train_batches(SEED, traffic, rcfg.decoder.num_classes,
                                   rcfg.decoder.clip_cls_emb_dim, "cpu")
    key = make_key(SEED % 2 ** 63, device="cpu")
    f32 = train_steps(build_reference(rcfg, state, "cpu"), list(batches), key, 2)
    low_model = build_reference(rcfg, state, "cpu", compute=True)
    low = train_steps(low_model, list(batches), key, 2)
    n = train_numbers(low, f32)
    assert 0 < n["loss_gap"] < 0.25 and 0 < n["grad_dist_med"] < 0.5, n
    assert all(t.dtype == torch.float32 for t in low["grad1_tensors"].values())
    w = dict(low_model.named_parameters())
    assert any(p.dtype == torch.bfloat16 for p in w.values())
