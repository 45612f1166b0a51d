"""The frozen plain reference against the port at the tiny configuration
on the CPU (float32: both run the plain laws there, so they agree to
rounding), on the benchmark's own seeded weights and inputs."""

import numpy as np
import pytest
import torch

from benchmark.harness import configs, inputs, weights
from benchmark.reference import rle
from benchmark.reference.univs import UniVSModel, build_reference, vis_video, vss_clip
from benchmark.tests.tiny import tiny_model

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def sides():
    torch.manual_seed(0)
    tree = tiny_model("float32")
    pcfg, rcfg = configs.program_config(tree), configs.reference_config(tree)
    with torch.device("meta"):
        shapes = UniVSModel(rcfg)
    state = weights.seeded_state(shapes, SEED, "cpu", torch.float32)
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.models.univs import build_model

    prog = build_model(pcfg, state, device="cpu")
    ref = build_reference(rcfg, state, "cpu")
    frames = inputs.noise_videos(SEED, 2, 1, 8, 64, 96, "cpu")[0]
    cls = inputs.class_bank(SEED, 5, rcfg.decoder.clip_cls_emb_dim, "cpu")
    return prog, ref, EntityDriver(pcfg, prog, num_classes=5, capacity=6, device="cpu"), frames, cls


def test_weights_are_seeded_and_load_strictly(sides):
    prog, ref, *_ = sides
    p, r = prog.state_dict(), ref.state_dict()
    assert set(p) == set(r) and all(torch.equal(p[k].float(), r[k]) for k in p)
    with torch.device("meta"):
        shapes = UniVSModel(ref.cfg)
    a = weights.seeded_state(shapes, SEED, "cpu", torch.bfloat16)
    b = weights.seeded_state(shapes, SEED + 1, "cpu", torch.bfloat16)
    key = "decoder.query_feat"
    assert a[key].dtype == torch.bfloat16 and not torch.equal(a[key], b[key])
    assert a["backbone.stem_bn.running_var"].float().eq(1).all()


def test_encode_and_decode_agree(sides):
    prog, ref, _, frames, cls = sides
    x = torch.as_tensor(frames[:3])
    with torch.no_grad():
        mf, ms = ref.encode(x)
        pf = prog.pixel_decoder(prog.backbone(prog.normalize(x)))
        torch.testing.assert_close(pf[0], mf, rtol=1e-4, atol=1e-4)
        fi = torch.arange(3)[None]
        a = prog.decoder(pf[3], pf[0], fi, task="detection", cls_emb=cls)
        b = ref.decoder(ms, mf, fi, task="detection", cls_emb=cls)
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-4)


def test_vis_loop_agrees(sides):
    _, ref, driver, frames, cls = sides
    results = driver.run_vis(frames, cls)
    got = vis_video(ref, torch.as_tensor(frames), cls, capacity=6)
    assert {r["obj_id"] for r in results} == set(np.flatnonzero(got["valid"]).tolist())
    for r in results:
        m = np.stack([rle.decode_numpy(s) for s in r["segmentations"]]).astype(bool)
        assert (m == got["masks"][r["obj_id"]]).mean() > 0.999


def test_vss_labels_agree(sides):
    _, ref, driver, frames, cls = sides
    labels = driver.run_vss(frames, cls)
    for c in (0, 1):
        idx = np.arange(c * 5, min(c * 5 + 5, 8))
        ev = vss_clip(ref, torch.as_tensor(frames[idx]), idx, cls)["evidence"]
        assert (ev.argmax(1).numpy() == labels[idx]).mean() > 0.999
