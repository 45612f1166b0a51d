"""The port's user and measurement tools (``univs_tpu_torch/tools/``)
against the JAX package's ``tools/`` on the CPU, at tiny size:

- ``extract_class_embeddings``: ``load_names`` and the padded batching
  over a names file with a synonym row and a blank line, against JAX's
  ``load_names`` plus its ``encode_category_names`` loop, both towers read
  from one fabricated OpenAI-named ``.pth`` at width 64 (one head), in one
  process (the tokenizer's fallback ids agree within one process only);
  the bank within 1e-5;
- ``semantic_feature_to_mask``: both tools ``--tiny`` on one ``.npz`` and
  one reference-named checkpoint: ``summary.json`` and the PNG grids
  byte-identical;
- ``show_results`` (registry and raw-file paths) and
  ``validate_datasets`` on a synthetic tree: the same problems, printed
  lines, exit code, overlays and frames;
- ``analyze_model``: the total and per-top-level parameter counts equal
  JAX's ``jax.eval_shape`` tree at full R50 width;
- ``probe_tent_sweep``: ``production_rows`` / ``hit_rate`` bit for bit
  against JAX's at JAX's constants;
- the benches and profiles: a ``--device cpu`` smoke of each at tiny size
  (printed lines, returned keys), and the served batch's entities equal
  to ``EntityDriver.run_vis``'s per video;
- every tool that runs a model refuses the CPU unless ``--device cpu``."""

import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from torch_convert_util import (clip_text_reference, meta_shapes, random_arrays,  # noqa: E402
                                save_reference, univs_reference)
from torch_tools_util import DATASET, write_ytvis_tree  # noqa: E402
from univs_tpu_torch.config import tiny_test_config  # noqa: E402
from univs_tpu_torch.models.clip_text import ClipTextEncoder  # noqa: E402
from univs_tpu_torch.models.univs import build_model  # noqa: E402
from univs_tpu_torch.tools import (analyze_model, bench_occupancy, bench_serving,  # noqa: E402
                                   extract_class_embeddings, probe_tent_sweep, profile_gather,
                                   profile_stages, semantic_feature_to_mask, show_results,
                                   validate_datasets)

torch.set_num_threads(1)

BANK_TOL = 1e-5
TOWER = dict(embed_dim=16, width=64, heads=1, num_layers=2)  # heads = width / 64
NAMES = ["person", "", "tench, Tinca tinca,", "traffic_light/signal", "bear+cub", "dog",
         "sports ball"]


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _jax_main(main, argv):
    old = sys.argv
    sys.argv = ["tool.py"] + list(argv)
    try:
        return _stdout(main)
    finally:
        sys.argv = old


# -- extract_class_embeddings ----------------------------------------------


def test_extract_class_embeddings_equals_jax(tmp_path):
    from tools import extract_class_embeddings as jax_tool
    from univs_tpu.models.clip_text import ClipTextEncoder as JaxClipTextEncoder
    from univs_tpu.models.clip_text import TextPromptEncoder as JaxTextPromptEncoder
    from univs_tpu.models.tokenizer import ClipTokenizer as JaxClipTokenizer
    from univs_tpu.utils.convert import convert_clip_text, flatten_torch

    names_file = tmp_path / "names.txt"
    names_file.write_text("\n".join(NAMES) + "\n")
    pth = str(tmp_path / "clip_text.pth")
    save_reference(pth, clip_text_reference(random_arrays(meta_shapes(
        lambda: ClipTextEncoder(**TOWER)), 3)))
    names = extract_class_embeddings.load_names(str(names_file))
    assert names == jax_tool.load_names(str(names_file)) and len(names) == 6

    out = str(tmp_path / "bank.npy")
    got, text = _stdout(extract_class_embeddings.main, [
        "--names", str(names_file), "--clip-weights", pth, "--out", out, "--batch", "4",
        "--device", "cpu"])
    assert text.splitlines() == ["6 category names", "0/6", f"wrote {out} (6, 16)"]
    assert np.array_equal(np.load(out), got)

    # JAX's tool loop, its tower at this width from the same file
    sd = flatten_torch(torch.load(pth, map_location="cpu", weights_only=False))
    tpe = JaxTextPromptEncoder({"params": convert_clip_text(sd, num_layers=2, width=64)},
                               JaxClipTextEncoder(**TOWER), JaxClipTokenizer())
    want = []
    for i in range(0, len(names), 4):
        chunk = names[i:i + 4]
        emb = np.asarray(tpe.encode_category_names(chunk + ["object"] * (4 - len(chunk))))
        want.append(emb[:len(chunk)])
    want = np.concatenate(want)
    assert got.shape == want.shape == (6, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=BANK_TOL)
    assert float(np.abs(want[0] - want[1]).max()) > 1e-3  # rows differ

    # the padding is inert: a batch of one gives the same rows
    tower = extract_class_embeddings.text_encoder(pth, "cpu")
    np.testing.assert_allclose(extract_class_embeddings.extract(tower, names, 1), got,
                               rtol=0, atol=BANK_TOL)


# -- semantic_feature_to_mask ----------------------------------------------


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """The tiny config's seeded model (seed 0) as a reference-named .pth."""
    path = str(tmp_path_factory.mktemp("weights") / "univs_tiny.pth")
    save_reference(path, univs_reference(build_model(tiny_test_config(), None, seed=0,
                                                     device="cpu").state_dict()))
    return path


@pytest.mark.parametrize("flags", [["--all"],
                                   ["--cls-thres", "0.5", "--quality-thres", "-1",
                                    "--cls-start", "0"]], ids=["all", "filtered"])
def test_semantic_feature_to_mask_equals_jax(tmp_path, tiny_weights, flags):
    from tools import semantic_feature_to_mask as jax_tool

    cfg = tiny_test_config()
    weights = tiny_weights
    rng = np.random.RandomState(0)
    T, h, w, K = 6, 8, 12, 10
    np.savez(tmp_path / "features.npz",
             obj_tokens=rng.randn(T, cfg.decoder.hidden_dim, cfg.decoder.num_queries)
             .astype(np.float32),
             mask_feats=rng.randn(T, h, w, cfg.decoder.mask_dim).astype(np.float32),
             cls_emb=rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32))
    common = [str(tmp_path / "features.npz"), "--weights", weights, "--tiny", *flags]
    got, _ = _stdout(semantic_feature_to_mask.main,
                     common + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    _jax_main(jax_tool.main, common + ["--out", str(tmp_path / "jax")])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files and "summary.json" in files
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert got["shape"] == [cfg.decoder.num_queries if "--all" in flags else len(
        got["kept_queries"]), T, h, w]
    if "--all" in flags:
        assert got["kept_queries"] == list(range(cfg.decoder.num_queries))


# -- show_results / validate_datasets -------------------------------------


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    monkeypatch.setenv("UNIVS_TPU_DATA_ROOT", str(tmp_path))
    data = write_ytvis_tree(str(tmp_path), H=32, W=40, V=3)
    return tmp_path, data


def test_show_results_equals_jax(tree):
    import cv2

    from tools import show_results as jax_tool
    from univs_tpu_torch.data.datasets import get_spec
    from univs_tpu_torch.utils import rle

    root, data = tree
    anns = data["annotations"]
    preds = [{"video_id": 1, "score": s, "category_id": a["category_id"],
              "segmentations": [a["segmentations"][0], None, a["segmentations"][2]]}
             for a, s in zip(anns, (0.9, 0.2))]
    preds.append({"video_id": 7, "score": 0.8, "category_id": 1, "segmentations": []})
    results = root / "results.json"
    results.write_text(json.dumps(preds))
    spec = get_spec(DATASET)
    raw = ["--videos-json", str(root / spec.json_path), "--image-root", str(root / spec.image_root)]
    for label, where in (("registry", ["--dataset", DATASET]), ("raw", raw)):
        common = ["--results", str(results), "--conf", "0.3", *where]
        got, got_text = _stdout(show_results.main, common + ["--output", str(root / "port")])
        _, want_text = _jax_main(jax_tool.main, common + ["--output", str(root / "jax")])
        assert got_text.replace("port", "jax") == want_text, label
        assert [(os.path.basename(p), n, k) for p, n, k in got] == [("video_1.avi", 3, 1)]
        a, b = (root / d / "video_1.avi" for d in ("port", "jax"))
        assert a.read_bytes() == b.read_bytes(), label
    cap = cv2.VideoCapture(str(root / "port" / "video_1.avi"))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    assert len(frames) == 3 and frames[0].shape == (32, 40, 3)
    assert rle.decode(anns[0]["segmentations"][0]).sum() > 0


def test_validate_datasets_equals_jax(tree, monkeypatch):
    from tools import validate_datasets as jax_tool
    from univs_tpu.data import datasets as jax_datasets
    from univs_tpu_torch.data import datasets as port_datasets

    root, data = tree
    bad = dict(data, categories=[{"id": 99, "name": "zz"}])
    (root / "bad.json").write_text(json.dumps(bad))
    gone = dict(data, videos=[dict(data["videos"][0], file_names=["v1/zzz.jpg"])])
    (root / "gone.json").write_text(json.dumps(gone))
    (root / "broken.json").write_text("{not json")
    img = port_datasets.get_spec(DATASET).image_root
    specs = [("toy_ok", port_datasets.get_spec(DATASET).json_path, img, None),
             ("toy_gone", "none.json", "nowhere", None),
             ("toy_badcat", "bad.json", img, "ytvis21"),
             ("toy_noframes", "gone.json", img, None),
             ("toy_broken", "broken.json", img, None)]
    for mod in (jax_datasets, port_datasets):
        for name, jp, ir, ns in specs:
            monkeypatch.setitem(mod._CATALOG, name, mod.DatasetSpec(name, jp, ir, "ytvis",
                                                                    namespace=ns))
    names = [s[0] for s in specs] + ["not_registered"]
    for name in names[:-1]:
        for parse in (False, True):
            got = validate_datasets.check_one(name, parse)
            assert got == jax_tool.check_one(name, parse), (name, parse)
    assert validate_datasets.check_one("toy_badcat", True)[0].endswith(
        "category ids outside namespace 'ytvis21' (1..40): [99]")
    argv = ["--datasets", ",".join(names), "--parse"]
    got_rc, got_text = _stdout(validate_datasets.main, argv)
    want_rc, want_text = _jax_main(jax_tool.main, argv)
    assert (got_rc, got_text) == (want_rc, want_text) and got_rc == 1
    assert got_text.splitlines()[-1].startswith("1 ok, 1 not on disk, 4 broken")


# -- analyze_model ---------------------------------------------------------


def test_analyze_model_parameter_counts_equal_jax():
    import jax
    import jax.numpy as jnp

    from univs_tpu.config import BackboneConfig, UniVSConfig
    from univs_tpu.models.univs import UniVSModel
    from univs_tpu.structures import TextPrompts
    from univs_tpu_torch.config import BackboneConfig as TBackboneConfig
    from univs_tpu_torch.config import UniVSConfig as TUniVSConfig

    cfg = UniVSConfig(backbone=BackboneConfig(name="resnet50"))
    model = UniVSModel(cfg)
    images, fi = jnp.zeros((1, 2, 64, 64, 3)), jnp.arange(2)[None]
    cls_emb = jnp.zeros((4, cfg.decoder.clip_cls_emb_dim))
    tp = TextPrompts(embs=cls_emb[None, :, None, :], valid=jnp.ones((1, 4), bool))
    params = jax.eval_shape(lambda r: model.init(
        {"params": r}, images, fi, task="detection", text_prompts=tp, cls_emb=cls_emb),
        jax.random.PRNGKey(0))["params"]
    count = lambda tree: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    want = {name: count(sub) for name, sub in params.items()}
    got = analyze_model.parameter_counts(TUniVSConfig(backbone=TBackboneConfig(name="resnet50")))
    assert got == want and list(got) == sorted(want)
    assert sum(got.values()) == count(params) > 40_000_000


def test_analyze_model_smoke():
    out, text = _stdout(analyze_model.main, ["--tiny", "--device", "cpu", "--height", "32",
                                             "--width", "64", "--frames", "2"])
    lines = text.splitlines()
    assert lines[0] == f"total params: {out['total_params'] / 1e6:.2f}M"
    assert [line.split(":")[0].strip() for line in lines[1:4]] == [
        "backbone", "decoder", "pixel_decoder"]
    assert lines[4].startswith("forward FLOPs (32x64, T=2): ")
    assert "not added" in lines[6] and lines[7].startswith("bytes accessed: not measured")
    cfg = tiny_test_config()
    assert out["encoder_layer_calls"] == cfg.pixel_decoder.num_layers
    assert out["launches"] == {k: 0 for k in out["launches"]} and out["flops"] > 0
    model = build_model(cfg, None, seed=0, device="cpu")
    assert out["total_params"] == sum(t.numel() for t in model.state_dict().values())


# -- probe_tent_sweep ------------------------------------------------------


def test_probe_tent_sweep_laws_equal_jax():
    from tools import probe_tent_sweep as jax_tool

    shapes = ((80, 120), (40, 60), (20, 30))
    for lid in (0, 1):
        got = probe_tent_sweep.production_rows(shapes, lid)
        want = jax_tool.production_rows(shapes, lid)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))
        hh = shapes[lid][0]
        for hw in ((16, 24, 32) if lid == 0 else (12, 16, 20)):
            assert probe_tent_sweep.hit_rate(got[1], hh, hw, 32, 4) == jax_tool.hit_rate(
                want[1], hh, hw, 32, 4)
    assert probe_tent_sweep.TPU_TENT_SUB == jax_tool.da._TENT_SUB
    assert probe_tent_sweep.TPU_TENT_BQ == jax_tool.da._TENT_BQ


def test_probe_tent_sweep_smoke():
    records = probe_tent_sweep.run("cpu", shapes=((16, 12), (8, 6), (4, 3)), levels=(0, 1),
                                   M=2, P=2, N=1, D=8, windows={0: (8,), 1: (4,)},
                                   sub_sweep={0: (8, 128)}, bqq=128, subq=64)
    assert [r["formulation"] for r in records] == [
        "cur (kernel A)", "plane (full-H)", "plane-win", "plane-win",
        "cur (kernel A)", "plane (full-H)", "plane-win"]
    assert all(r["pass"] and r["ms"] is None for r in records)
    assert all(0.0 <= r["hit"] <= 1.0 and 0.0 <= r["tpu_hit"] <= 1.0
               for r in records if "hit" in r)


# -- benches and profiles --------------------------------------------------

SMALL = ["--tiny", "--height", "32", "--width", "64", "--device", "cpu", "--dtype", "float32"]


def test_bench_serving_smoke():
    rows, text = _stdout(bench_serving.main, ["1", "2", "--frames", "4", "--iters", "1", *SMALL])
    assert [r["B"] for r in rows] == [1, 2]
    assert all(r["fps"] > 0 and r["videos_per_s"] > 0 for r in rows)
    assert "B=2: " in text and "| B | s/batch | per-card FPS | videos/s |" in text


def test_served_entities_equal_entity_driver():
    """The bench's ``run_frames`` on frames already on the device: each
    video's entities equal ``EntityDriver.run_vis``'s, with the gates open
    so that entities are admitted."""
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.inference.serving import BatchedVISServer
    from univs_tpu_torch.utils.synth import synth_blob_video

    cfg = bench_occupancy.floored(tiny_test_config())
    model = build_model(cfg, None, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    cls_emb = torch.as_tensor(rng.randn(bench_serving.K, 16).astype(np.float32))
    videos = [synth_blob_video(4, 48, 64, n_blobs=6, seed=s) for s in (1, 2)]
    srv = BatchedVISServer(cfg, model, num_classes=bench_serving.K, capacity=bench_serving.E,
                           batch_size=2, device="cpu")
    got = srv.run_frames(torch.as_tensor(np.stack(videos)), [4, 4], cls_emb)
    for video, g in zip(videos, got):
        want = EntityDriver(cfg, model, num_classes=bench_serving.K, capacity=bench_serving.E,
                            device="cpu").run_vis(video, cls_emb)
        assert len(g) == len(want) > 0
        for a, b in zip(g, want):
            assert a["segmentations"] == b["segmentations"]
            np.testing.assert_allclose(a["score_windows"], b["score_windows"], rtol=0, atol=1e-6)


def test_bench_occupancy_smoke():
    out, text = _stdout(bench_occupancy.main, ["--frames", "4", "--iters", "1", *SMALL])
    lines = text.splitlines()
    assert lines[0] == "warm-up..."
    assert lines[1] == f"occupancy: {out['entities']} / {out['capacity']} slots"
    assert lines[2].startswith("pipelined driver: ") and lines[3].startswith("standard gates: ")
    assert out["entities"] > out["entities_standard"] and out["fps"] > 0


def test_profile_stages_smoke():
    out, text = _stdout(profile_stages.main, ["--frames", "2", "--iters", "1", *SMALL])
    assert [line.split(":")[0] for line in text.splitlines()] == [
        "backbone", "backbone+pixel_decoder", "full forward"]
    assert all(out[k] > 0 for k in ("backbone_ms", "encode_ms", "full_ms", "fps"))


def test_profile_gather_smoke():
    out, text = _stdout(profile_gather.main, ["--tiny", "--device", "cpu", "--iters", "1",
                                              "--warmup", "1"])
    assert [line.split(":")[0] for line in text.splitlines()] == [
        "gather take_along", "ms_deform_attn full", "MSDeformAttnLayer", "grid2d PEs",
        "GroupNorm"]
    assert all(v > 0 for k, v in out.items() if k.endswith("_ms"))


# -- the CPU only on request -----------------------------------------------


@pytest.mark.parametrize("tool,argv", [
    (extract_class_embeddings, ["--names", "absent.txt"]),
    (semantic_feature_to_mask, ["absent.npz", "--tiny"]),
    (analyze_model, ["--tiny"]),
    (bench_serving, ["1", "--tiny"]),
    (bench_occupancy, ["--tiny"]),
    (profile_stages, ["--tiny"]),
    (profile_gather, ["--tiny"]),
    (probe_tent_sweep, []),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_tools_refuse_cpu_without_request(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)


def test_config_of_the_benches_follows_the_flags():
    args = bench_serving.parse_args(["--dtype", "float32"])
    assert bench_serving.bench_config(args).dtype == "float32"
    assert (args.height, args.width, args.frames, args.batch_sizes) == (640, 960, 30,
                                                                        [1, 2, 4, 8])
    assert dataclasses.asdict(bench_occupancy.floored(tiny_test_config()).inference)[
        "nms_thres"] == 1.5
