"""Backbone families found by name (``reference/models/backbones/<family>.py``).

A family added as one new file, in a copy of the benchmark, is taken by
the reference model, the seeded weights, the operation counts and the
configuration's lookup with no other file edited; a key no family
declares still raises.  The golden test holds the three cells'
configurations and the tiny one to the values recorded before ResNet and
Swin became family files: the seeded state (a SHA-256 over every leaf's
name, dtype, shape and bytes), the reference's outputs on one seeded
input at a small size, and the operation counts, exactly."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import configs, flops, inputs, weights
from benchmark.tests.tiny import BENCH, ROOT, tiny_model

SEED = 2 ** 31 + 2021

# recorded on the tree before the family files (torch 2.x on an x86 CPU,
# one thread); the outputs are sums in float64 over every element
GOLD = {
    "tiny": {"state": "aab4cc89059681eee17c19e1a6b88b98d5982994c1816fe172792833aa03e28f",
             "pred_logits": [76.01005314290524, 157.25323666632175],
             "pred_masks": [-6617.04185214563, 9185.42425670597],
             "evidence": [6927.121079130731, 6927.121079130731],
             "vis_frame_flops": 104302535168.0, "vss_frame_flops": 102615481344.0,
             "train_clip_flops": 1057645615104.0},
    "univs-r50": {"state": "80a31a59033ba7be89a4fc1afd967faa3ab67ea387e67487dca58130569ff7d8",
                  "pred_logits": [-244.2676935432537, 384.86627143618534],
                  "pred_masks": [-487865.0021630735, 508490.1081906208],
                  "evidence": [70979.4905825574, 70979.4905825574],
                  "vis_frame_flops": 547704576682.6667, "vss_frame_flops": 305390182400.0,
                  "train_clip_flops": 3680247988224.0},
    "univs-swinl": {"state": "805bfe064095d7253f055d54551318d9860f52d7c30b01fbb70a845ae98c8264",
                    "pred_logits": [352.6547033172137, 533.6111674988606],
                    "pred_masks": [23617.790631164287, 456141.120149893],
                    "evidence": [2096346.81977397, 2096346.81977397],
                    "vis_frame_flops": 1369157180074.6667, "vss_frame_flops": 1126842785792.0,
                    "train_clip_flops": 12207418490880.0},
}


def _traffic(name):
    return json.load(open(os.path.join(BENCH, "traffic", f"{name}.json")))


def model_tree(name):
    if name == "tiny":
        return tiny_model("float32")
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))["model"]


def state_digest(state) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(raw.numpy().tobytes())
    return h.hexdigest()


def fingerprint(name) -> dict:
    """The seeded state's digest, the reference's outputs on one seeded
    2-frame clip at 64 x 96 (sums and absolute sums of the class and mask
    logits and the evidence) and the operation counts of a configuration."""
    from benchmark.reference.univs import UniVSModel, build_reference, strict_float32, vss_clip

    torch.set_num_threads(1)
    strict_float32()
    tree = model_tree(name)
    rcfg = configs.reference_config(tree)
    with torch.device("meta"):
        shapes = UniVSModel(rcfg)
    compute = torch.bfloat16 if tree.get("dtype") == "bfloat16" else torch.float32
    state = weights.seeded_state(shapes, SEED, "cpu", compute)
    out = {"state": state_digest(state)}
    ref = build_reference(rcfg, state, "cpu")
    del state
    frames = torch.as_tensor(inputs.noise_videos(SEED, 2, 1, 2, 64, 96, "cpu")[0])
    cls = inputs.class_bank(SEED, 5, rcfg.decoder.clip_cls_emb_dim, "cpu")
    with torch.no_grad():
        got = vss_clip(ref, frames, torch.arange(2).numpy(), cls)
    for k in ("pred_logits", "pred_masks", "evidence"):
        v = got[k].to(torch.float64)
        out[k] = [float(v.sum()), float(v.abs().sum())]
    out["vis_frame_flops"] = flops.frame_flops("vis_stream", tree, _traffic("vis_stream"))
    out["vss_frame_flops"] = flops.frame_flops("vss_stream", tree, _traffic("vss_stream"))
    out["train_clip_flops"] = flops.train_clip_flops(tree, _traffic("train_stage2"))
    return out


FAMILY = '''"""A test family: a strided-conv pyramid with one leaf of its own."""

from typing import Dict, Tuple

import torch
import torch.nn as nn

KEYS = {"toy_width": 8}


class Toy(nn.Module):
    def __init__(self, width, out_features):
        super().__init__()
        self.out_features = tuple(out_features)
        self.out_channels = {f"res{s + 2}": width * 2 ** s for s in range(4)}
        self.stem = nn.Conv2d(3, width, 4, stride=4)
        self.gain = nn.Parameter(torch.zeros(width))
        for s in range(3):
            setattr(self, f"down{s}", nn.Conv2d(width * 2 ** s, width * 2 ** (s + 1), 2, stride=2))

    def forward(self, x):
        x = self.stem(x.permute(0, 3, 1, 2)) * self.gain[None, :, None, None]
        outs = {"res2": x}
        for s in range(3):
            x = getattr(self, f"down{s}")(x)
            outs[f"res{s + 3}"] = x
        return {k: v.permute(0, 2, 3, 1) for k, v in outs.items() if k in self.out_features}


def build(cfg):
    return Toy(cfg.toy_width, cfg.out_features)


def flops(tree, H, W) -> Tuple[float, Dict[str, int]]:
    c, h, w = tree["toy_width"], H // 4, W // 4
    ops = 2.0 * 16 * 3 * c * h * w
    for s in range(3):
        h, w = h // 2, w // 2
        ops += 2.0 * 4 * c * 2 ** s * c * 2 ** (s + 1) * h * w
    return ops, {f"res{s + 2}": c * 2 ** s for s in range(4)}


def leaf_rule(mod, leaf):
    if isinstance(mod, Toy) and leaf == "gain":
        return "const", 0.5
    return None
'''

SCRIPT = r'''
import json, sys
sys.path.insert(0, ROOT)
import pytest, torch
from benchmark.harness import configs, flops, weights
from benchmark.reference.models.backbones import family
from benchmark.reference.univs import UniVSModel, build_reference
from benchmark.tests.tiny import tiny_model

tree = tiny_model("float32")
tree["backbone"] = {"name": "toy3", "toy_width": 16,
                    "out_features": ["res2", "res3", "res4", "res5"]}
rc = configs.reference_config(tree)
with torch.device("meta"):
    shapes = UniVSModel(rc)
state = weights.seeded_state(shapes, 7, "cpu", torch.float32)
ref = build_reference(rc, state, "cpu")
mf, ms = ref.encode(torch.zeros((1, 64, 96, 3)))
traffic = dict(tiny_model()["inference"], height=64, width=96, frames=8, classes=5)
got = {"file": family("toy3").__file__, "width": rc.backbone.toy_width,
       "kind": type(shapes.backbone).__name__, "gain": state["backbone.gain"].unique().tolist(),
       "mask_features": list(mf.shape), "levels": [list(m.shape) for m in ms],
       "backbone_flops": flops.backbone_flops(tree, 64, 96)[0],
       "frame_flops": flops.frame_flops("vss_stream", tree, traffic),
       "default": configs.reference_config(dict(tree, backbone={"name": "toy3"})).backbone.toy_width}
for bad in ({"name": "toy3", "no_such_key": 1}, {"name": "resnet50", "toy_width": 16}):
    with pytest.raises(KeyError):
        configs.reference_config(dict(tree, backbone=bad))
with pytest.raises(ValueError, match="nosuch.py"):
    configs.reference_config(dict(tree, backbone={"name": "nosuch_b1"}))
print(json.dumps(got))
'''


def test_a_family_added_as_one_file(tmp_path):
    """In a copy of the benchmark, a family that exists nowhere else,
    added as ``toy.py`` alone, is taken by the configuration's lookup (its
    ``KEYS``), the reference model, the seeded weights (its ``leaf_rule``)
    and the operation counts (its ``flops``)."""
    assert not os.path.exists(os.path.join(BENCH, "reference", "models", "backbones", "toy.py"))
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    fam = tmp_path / "benchmark" / "reference" / "models" / "backbones" / "toy.py"
    fam.write_text(FAMILY)
    out = subprocess.run([sys.executable, "-c", SCRIPT.replace("ROOT", repr(str(tmp_path)))],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"] == str(fam) and got["kind"] == "Toy" and got["width"] == 16
    assert got["default"] == 8 and got["gain"] == [0.5]
    assert got["mask_features"] == [1, 16, 24, 32] and got["levels"][0] == [1, 2, 3, 32]
    assert got["frame_flops"] > got["backbone_flops"] > 0


def test_a_name_without_a_family_file():
    from benchmark.reference.models.backbones import family, family_name

    assert [family_name(n) for n in ("resnet50", "swin_large", "pvt_v2_b5")] == [
        "resnet", "swin", "pvt"]
    with pytest.raises(ValueError, match="pvt.py"):
        family("pvt_v2_b5")
    with pytest.raises(KeyError):
        configs.reference_config({"backbone": {"name": "swin_large", "toy_width": 3}})


@pytest.mark.parametrize("name", ["tiny", "univs-r50", "univs-swinl"])
def test_families_keep_the_parent_values(name):
    got = fingerprint(name)
    want = GOLD[name]
    for k in ("state", "vis_frame_flops", "vss_frame_flops", "train_clip_flops"):
        assert got[k] == want[k], k
    for k in ("pred_logits", "pred_masks", "evidence"):
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


if __name__ == "__main__":
    for n in sys.argv[1:]:
        print(json.dumps({n: fingerprint(n)}), flush=True)
