"""The port's entry points against the JAX package's tools on the CPU, over
one synthetic ytvis tree (``ytvis_2019_val`` under ``UNIVS_TPU_DATA_ROOT``:
JSON, PNG frames, two GT ellipses stored as RLEs and one GT made from a
prediction, so AP lies strictly between 0 and 1) and one tiny
reference-named ``.pth`` (the port's seeded init):

- ``python -m univs_tpu_torch.tools.run_net --eval-only --tiny --device cpu
  --weights x.pth`` prints the metrics of JAX's ``tools/run_net.py`` on the
  same tree and weights, and writes the same ``results.json`` (scores to
  1e-5, as the engine tests);
- ``--train`` then ``--train --resume`` continues at the saved step
  (``(iter 2)``, then ``state_4``), ``metrics.jsonl`` holds JAX's keys (the
  JAX criterion's logged losses, traced with ``jax.eval_shape``), and
  ``--eval-only --weights ckpt_final`` runs;
- the port's ``demo.run`` (VIS, ``--mask``, ``--text``, ``--batch 2``,
  ``--parallel``) hands ``render_and_write`` the same results as JAX's
  ``tools/demo.py`` and writes its overlays.

JAX's tools call their ``init_params`` (a jitted flax init of the model)
before ``--weights`` replaces its output; the tests stub it, so that the
JAX side compiles only what computes the results."""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import demo as jax_demo  # noqa: E402
from tools import run_net as jax_run_net  # noqa: E402
from torch_convert_util import save_reference, univs_reference  # noqa: E402
from torch_engine_util import assert_same_predictions  # noqa: E402
from univs_tpu_torch.config import tiny_test_config  # noqa: E402
from univs_tpu_torch.data.datasets import get_spec  # noqa: E402
from univs_tpu_torch.models.univs import build_model  # noqa: E402
from univs_tpu_torch.tools import demo, run_net  # noqa: E402
from univs_tpu_torch.utils import rle  # noqa: E402

torch.set_num_threads(1)

H, W, V = 48, 64, 5
DATASET = "ytvis_2019_val"
SCORE_TOL = 1e-5


def _port_cli(argv):
    """The port's run_net in-process; its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_net.main(argv)
    return out.getvalue()


def _jax_cli(argv):
    old = sys.argv
    sys.argv = ["run_net.py"] + argv
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jax_run_net.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _metrics(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def _write_json(root, data):
    path = os.path.join(root, get_spec(DATASET).json_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tree, the weights, the JAX tools' init stubbed; the data root
    set for the module."""
    root = tmp_path_factory.mktemp("entry")
    spec = get_spec(DATASET)
    frames_dir = root / spec.image_root / "v1"
    frames_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = []
    for t in range(V):
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            frames_dir / f"{t:05d}.png")
        names.append(f"v1/{t:05d}.png")
    yy, xx = np.mgrid[0:H, 0:W]
    ellipses = [((((yy - cy) / 8.0) ** 2 + ((xx - cx) / 12.0) ** 2) <= 1).astype(np.uint8)
                for cy, cx in ((15, 20), (30, 45))]
    anns = [{"id": i + 1, "video_id": 1, "category_id": i + 1, "iscrowd": 0,
             "segmentations": [rle.encode(m)] * V} for i, m in enumerate(ellipses)]
    data = {"videos": [{"id": 1, "file_names": names, "height": H, "width": W, "length": V}],
            "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in range(1, 41)]}
    weights = str(root / "univs_tiny.pth")
    save_reference(weights, univs_reference(
        build_model(tiny_test_config(), None, seed=0, device="cpu").state_dict()))
    mask = np.zeros((H, W), np.uint8)
    for i, m in enumerate(ellipses):
        mask[m > 0] = i + 1
    Image.fromarray(mask).save(root / "first_frame.png")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIVS_TPU_DATA_ROOT", str(root))
        mp.setattr(jax_run_net, "init_params", lambda cfg, bank, seed=0: (None, None))
        _write_json(root, data)
        # one GT made from the port's first prediction: AP neither 0 nor 1
        out = str(root / "probe")
        _port_cli(["--eval-only", "--tiny", "--device", "cpu", "--weights", weights,
                   "--dataset", DATASET, "--output", out])
        with open(os.path.join(out, "results.json")) as f:
            pred = json.load(f)[0]
        data["annotations"].append({"id": 10, "video_id": 1, "iscrowd": 0,
                                    "category_id": pred["category_id"] + 1,
                                    "segmentations": pred["segmentations"]})
        _write_json(root, data)
        yield types.SimpleNamespace(root=root, weights=weights, frames=str(frames_dir),
                                    mask=str(root / "first_frame.png"))


def test_eval_only_prints_jax_metrics(env):
    common = ["--eval-only", "--tiny", "--weights", env.weights, "--dataset", DATASET]
    got = _metrics(_port_cli(common + ["--device", "cpu", "--output", str(env.root / "port")]))
    want = _metrics(_jax_cli(common + ["--output", str(env.root / "jax")]))
    assert 0.0 < want["AP"] < 1.0
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k != "fps":
            assert abs(got[k] - w) <= SCORE_TOL, (k, got[k], w)
    with open(env.root / "port" / "results.json") as f, open(env.root / "jax" / "results.json") as g:
        assert_same_predictions(json.load(f), json.load(g))


def _jax_logged_keys():
    """The keys JAX's train step logs for the CLI's tiny config: its
    criterion's losses and ``total_loss``, traced (``jax.eval_shape``) over
    a lighter trunk — the keys follow the decoder and the criterion's
    config, not the backbone."""
    import jax

    from torch_train_util import jax_batch, tiny_train_arrays
    from univs_tpu.losses.criterion import UniCriterion
    from univs_tpu.models.univs import UniVSModel
    from univs_tpu.structures import TextPrompts

    cfg, _ = jax_run_net.build_cfg(argparse.Namespace(tiny=True, vos_queries="prompt"))
    light = cfg.replace(backbone=dataclasses.replace(cfg.backbone, resnet_depth=10),
                        pixel_decoder=dataclasses.replace(cfg.pixel_decoder, num_layers=1))
    model = UniVSModel(light)
    batch = jax_batch(tiny_train_arrays(cfg), "detection")
    kw = dict(train=True, cls_emb=batch.category_bank, text_prompts=TextPrompts(
        embs=batch.prompt_category_embs[:, :, None, :], valid=batch.prompt_category_valid))
    crit = UniCriterion(cfg.train, cfg.decoder.num_queries, cfg.num_frames)

    def logged():
        r = jax.random.PRNGKey(0)
        params = model.init({"params": r, "shuffle": r, "prompt": r}, batch.images,
                            batch.frame_indices, task="detection", **kw)["params"]
        out = model.apply({"params": params}, batch.images, batch.frame_indices,
                          task="detection", rngs={"shuffle": r, "prompt": r}, **kw)
        return crit(r, out, batch.targets, batch.category_bank_valid, task="detection",
                    class_loss=True, sem_loss=True)[1]

    return set(jax.eval_shape(logged)) | {"total_loss"}


def test_train_resume_and_reload(env):
    out = str(env.root / "train")
    common = ["--train", "--tiny", "--device", "cpu", "--datasets", f"{DATASET}:1.0",
              "--batch-size", "2", "--image-size", "64", "--ckpt-every", "2", "--output", out]
    _port_cli(common + ["--max-iter", "2"])
    assert os.path.isfile(os.path.join(out, "state_2"))
    text = _port_cli(common + ["--max-iter", "4", "--resume"])
    # restored the full state at the recorded step, then ran iterations 2-3
    assert "resumed full train state" in text and "(iter 2)" in text
    assert os.path.isfile(os.path.join(out, "state_4"))
    final = torch.load(os.path.join(out, "ckpt_final"), weights_only=True)
    state4 = torch.load(os.path.join(out, "state_4"), weights_only=True)
    assert final["step"] == state4["step"] == 4
    assert all(torch.equal(final["params"][k], v) for k, v in state4["params"].items())
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["iteration"] for r in lines] == [0]  # JAX's cadence: it % 20 == 0
    assert set(lines[0]) == _jax_logged_keys() | {"iteration"}
    assert all(np.isfinite(v) for v in lines[0].values())
    metrics = _metrics(_port_cli(["--eval-only", "--tiny", "--device", "cpu", "--weights",
                                  os.path.join(out, "ckpt_final"), "--dataset", DATASET,
                                  "--output", str(env.root / "final")]))
    assert set(metrics) == {"AP", "AP50", "AP75", "AR100", "fps"}


@contextlib.contextmanager
def _recording(module):
    """Every ``render_and_write`` call of ``module``'s demo: (results, out_path)."""
    calls = []
    fn = module.render_and_write

    def record(frames, results, out_path, score_thres, render_pool=None):
        calls.append((results, out_path))
        return fn(frames, results, out_path, score_thres, render_pool)

    module.render_and_write = record
    try:
        yield calls
    finally:
        module.render_and_write = fn


MODES = {
    "vis": {},
    "mask": {"mask": True},
    "text": {"text": ["a red thing", "a dog"]},
    "batch2": {"batch": 2},
}


def _demo_args(env, out_dir, mode, **extra):
    """``out_dir``/out.avi, or the directory itself for several inputs."""
    kw = dict(MODES[mode])
    inputs, out = env.frames, os.path.join(out_dir, "out.avi")
    if kw.pop("mask", False):
        kw["mask"] = env.mask
    if mode == "batch2":  # two inputs of one resolution: one batch
        second = os.path.join(out_dir, "v2")
        if not os.path.isdir(second):
            shutil.copytree(env.frames, second)
        inputs, out = [env.frames, second], out_dir
    return types.SimpleNamespace(input=inputs, output=out, weights=env.weights, bank=None,
                                 dataset_ns="ytvis21", backbone="resnet50", score_thres=-1.0,
                                 tiny=True, max_frames=V, clip_weights=None, **kw, **extra)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["segmentations"] == w["segmentations"]
        for k in g:
            if k in ("segmentations",):
                continue
            gv, wv = np.asarray(g[k]), np.asarray(w[k])
            if gv.dtype.kind == "f":
                np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-6, err_msg=k)
            else:
                assert np.array_equal(gv, wv), k


@pytest.fixture(scope="module")
def jax_demo_results(env, tmp_path_factory):
    out = {}
    for mode in MODES:
        d = tmp_path_factory.mktemp(f"jax_demo_{mode}")
        with _recording(jax_demo) as calls:
            jax_demo.run(_demo_args(env, str(d), mode))
        out[mode] = calls
    return out


@pytest.mark.parametrize("mode,parallel", [("vis", False), ("vis", True), ("mask", False),
                                           ("text", False), ("batch2", True)])
def test_demo_hands_render_the_jax_results(env, jax_demo_results, tmp_path, mode, parallel):
    with _recording(demo) as calls:
        demo.run(_demo_args(env, str(tmp_path), mode, parallel=parallel, num_render_workers=2,
                            device="cpu"))
    want = jax_demo_results[mode]
    assert len(calls) == len(want) >= 1
    for (g, gpath), (w, _) in zip(calls, want):
        assert len(w) >= 1, "the demo must render something"
        _same_results(g, w)
        assert os.path.getsize(gpath) > 0


def test_event_writer_equals_jax(tmp_path, capsys):
    """The same ``metrics.jsonl`` lines and console lines (the it/s aside)."""
    import re

    from univs_tpu.utils.events import EventWriter as JaxEventWriter
    from univs_tpu_torch.utils.events import EventWriter

    texts = {}
    for name, cls in (("port", EventWriter), ("jax", JaxEventWriter)):
        w = cls(str(tmp_path / name), print_every=2, smoothing=3)
        for it in range(5):
            w.log(it, {"total_loss": 1.0 / (it + 1), "loss_ce": torch.tensor(0.5 * it),
                       "lr": np.float32(1e-4)})
        w.close()
        texts[name] = re.sub(r"\([0-9.]+ it/s\)", "", capsys.readouterr().out)
    assert texts["port"] == texts["jax"] and texts["port"].count("iter ") == 3
    assert (tmp_path / "port" / "metrics.jsonl").read_text() == \
        (tmp_path / "jax" / "metrics.jsonl").read_text()


def test_profiling_on_the_cpu(tmp_path):
    """``trace`` writes a non-empty trace file into its directory;
    ``StageTimer`` accumulates stages (``sync`` a tensor or a tuple of
    them) and its summary is JAX's text for the same totals."""
    from univs_tpu.utils.profiling import StageTimer as JaxStageTimer
    from univs_tpu_torch.utils.profiling import StageTimer, trace

    with trace(str(tmp_path / "trace")):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    timer = StageTimer()
    for sync in (x, (x, x[0]), None):
        with timer.stage("encode", sync=sync):
            x = x + 1
    with timer.stage("decode"):
        pass
    assert timer.counts == {"encode": 3, "decode": 1}
    jt = JaxStageTimer()
    jt.totals.update(timer.totals)
    jt.counts.update(timer.counts)
    assert timer.summary() == jt.summary() and "encode: " in timer.summary()


def test_clip_weights_build_the_text_tower(tmp_path):
    """``--clip-weights`` with OpenAI naming: the tower's geometry read from
    the weights (heads = width / 64, as OpenAI's CLIP), its weights through
    ``convert_clip_text`` equal to the tower they were made from."""
    from torch_convert_util import clip_text_reference
    from univs_tpu_torch.models.clip_text import ClipTextEncoder
    from univs_tpu_torch.utils import weights

    tower = ClipTextEncoder(embed_dim=16, width=128, heads=2, num_layers=2)
    weights.init_params(tower, 3)
    want = tower.state_dict()
    torch.save({k: torch.as_tensor(v) for k, v in clip_text_reference(want).items()},
               tmp_path / "clip.pth")
    enc = run_net.text_encoder_from(str(tmp_path / "clip.pth"), "cpu")
    got = enc.encoder.state_dict()
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert enc.encoder.num_layers == 2 and enc.encoder.block_0.attn.num_heads == 2
    word, sent = enc.encode_expressions(["a dog"])
    assert tuple(word.shape) == (1, 77, 16) and bool(torch.isfinite(sent).all())
