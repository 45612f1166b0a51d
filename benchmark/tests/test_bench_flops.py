"""The arithmetic of operations, bytes and bounds."""

import json

import pytest

from benchmark.harness import flops
from benchmark.reference.models.backbones.resnet import resnet_flops
from benchmark.reference.models.backbones.swin import swin_flops
from benchmark.tests.tiny import BENCH


def test_encoder_kernel_bounds_at_the_30_frame_shape():
    shapes = flops.level_shapes(640, 960)
    assert shapes == ((20, 30), (40, 60), (80, 120))
    got = {k: flops.kernel_work(k, 30, shapes, 256, 8, 4, 1024) for k in
           ("msda_sample", "msda_rows", "fused_ffn_ln")}
    assert round(got["msda_sample"]["bound_ms"], 3) == 0.246
    assert round(got["msda_rows"]["bound_ms"], 3) == 0.188
    assert round(got["fused_ffn_ln"]["bound_ms"], 3) == 0.401
    assert [got[k]["bound_by"] for k in got] == ["bytes", "bytes", "operations"]
    five = flops.kernel_work("fused_ffn_ln", 5, shapes, 256, 8, 4, 1024)["bound_ms"]
    assert five == pytest.approx(got["fused_ffn_ln"]["bound_ms"] / 6)


def test_backbones_against_published_counts():
    # torchvision ResNet-50 at 224^2: 4.09 GMACs; Swin-L (window 7) 34.5 GMACs
    r50, chans = resnet_flops(50, 224, 224)
    assert r50 / 2 == pytest.approx(4.09e9, rel=0.02)
    assert chans == {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}
    swin, _ = swin_flops("swin_large", 7, 224, 224)
    assert swin / 2 == pytest.approx(34.5e9, rel=0.03)


def test_frame_counts_follow_the_configuration():
    r50 = json.load(open(f"{BENCH}/configs/univs-r50.json"))["model"]
    swin = json.load(open(f"{BENCH}/configs/univs-swinl.json"))["model"]
    vis = json.load(open(f"{BENCH}/traffic/vis_stream.json"))
    vss = json.load(open(f"{BENCH}/traffic/vss_stream.json"))
    a = flops.frame_flops("vis_stream", r50, vis)
    b = flops.frame_flops("vss_stream", swin, vss)
    assert 0.5e12 < a < 0.6e12 and 1.1e12 < b < 1.2e12
    deeper = dict(r50, decoder=dict(r50["decoder"], num_layers=18))
    assert flops.frame_flops("vis_stream", deeper, vis) > a
