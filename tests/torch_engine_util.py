"""Shared set-up of the engine parity tests (``tests/test_torch_engine_*.py``):
the tiny config of both packages with relaxed gates, JAX parameters
initialised under ``jax.jit`` and the port's state_dict made from them,
toy records with RLE ground truth, an in-memory eval mapper per package,
and the comparisons of metrics, ``results.json`` and output trees."""

import contextlib
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from univs_tpu.config import tiny_test_config as jax_tiny_config
from univs_tpu.data import augment as jax_augment
from univs_tpu.models.univs import UniVSModel as JaxUniVSModel
from univs_tpu.structures import TextPrompts as JaxTextPrompts
from univs_tpu_torch.config import tiny_test_config
from univs_tpu_torch.data import augment
from univs_tpu_torch.utils import rle
from univs_tpu_torch.utils.weights import state_dict_from_flax

K = 5
H, W, V = 50, 70, 4
# float32 class scores of the two packages differ in their last bits; every
# other field of a results file, and every metric, is compared exactly
SCORE_RTOL = 1e-5


def relaxed(cfg):
    """2-frame clips at stride 1, a 4-frame window, 64-pixel short edge,
    class and consistency gates open, so random weights admit entities."""
    inf = dataclasses.replace(
        cfg.inference, num_frames=2, clip_stride=1, num_frames_window=4, min_size_test=64,
        size_divisibility=32, apply_cls_thres=0.0, topk_per_video=5, max_num_instances=6,
        consistency_thres=(-1.0, 0.5))
    return dataclasses.replace(cfg, inference=inf,
                               prompt=dataclasses.replace(cfg.prompt, num_prev_frames_memory=3))


def setup():
    """(jax cfg, port cfg, flax params, port state_dict, [K, 16] bank)."""
    jcfg, tcfg = relaxed(jax_tiny_config()), relaxed(tiny_test_config())
    cls_bank = np.random.RandomState(0).randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32)
    model = JaxUniVSModel(jcfg)
    tp = JaxTextPrompts(embs=jnp.asarray(cls_bank)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: model.init({"params": r}, im, fi, task="detection",
                                                text_prompts=tp, cls_emb=jnp.asarray(cls_bank)))
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 96, 3)), jnp.arange(2)[None])
    params = jax.tree.map(np.asarray, params["params"])
    return jcfg, tcfg, params, state_dict_from_flax(params), cls_bank


def box(y0, y1, x0, x1, h=H, w=W):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


def toy_records(task="detection", length=V, video_id=1):
    """One video, two objects: a box in every frame, and one that appears
    at frame 1 (None before)."""
    a = rle.encode(box(5, 25, 5, 30))
    b = rle.encode(box(30, 45, 40, 65))
    return [{
        "video_id": video_id, "video_name": f"video_{video_id}", "dataset_name": "toy",
        "file_names": [f"v{video_id}/{t:05d}.jpg" for t in range(length)],
        "height": H, "width": W, "length": length, "task": task,
        "annotations": [
            {"id": 1, "category_id": 1, "raw_category_id": 61, "iscrowd": 0,
             "segmentations": [a] * length},
            {"id": 2, "category_id": 2, "raw_category_id": 29, "iscrowd": 0,
             "segmentations": [None] + [b] * (length - 1)},
        ],
    }]


class ArrayMapper:
    """The eval mapper over seeded in-memory frames, through one package's
    ``augment`` (no file decode)."""

    def __init__(self, aug):
        self.aug = aug

    def __call__(self, record):
        h, w, n = record["height"], record["width"], record["length"]
        r = np.random.RandomState(record["video_id"])
        frames = [(r.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(n)]
        t = self.aug.resize_shortest_edge((h, w), 64, 128, 32)
        return {"images": np.stack([t.apply_image(f) for f in frames]).astype(np.float32),
                "image_size": self.aug.transformed_image_size(t, (h, w)), "out_size": (h, w),
                "video_id": record["video_id"], "video_len": n,
                "dataset_name": record["dataset_name"], "task": record["task"],
                "record": record, "transform": t}


JAX_MAPPER, MAPPER = ArrayMapper(jax_augment), ArrayMapper(augment)


def assert_same_metrics(got, want):
    """Every metric equal (NaN where JAX's is NaN); fps excluded."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "fps":
            continue
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), k
        else:
            assert type(g) is type(w) and g == w, (k, g, w)


def assert_same_predictions(got, want):
    """Result files' records: the same records in the same order, every
    field equal, ``score`` within ``SCORE_RTOL``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
        assert abs(g["score"] - w["score"]) <= SCORE_RTOL * abs(w["score"]), \
            (g["score"], w["score"])


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_outputs(got_dir, want_dir, results=()):
    """The same files; ``results`` (JSON prediction lists) as
    ``assert_same_predictions``, every other file byte-identical."""
    got, want = tree(got_dir), tree(want_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        if name in results:
            assert_same_predictions(json.loads(got[name]), json.loads(want[name]))
        else:
            assert got[name] == want[name], name


@contextlib.contextmanager
def recording(cls, name: str, outputs: list):
    """Append every return value of ``cls.name`` to ``outputs`` while the
    block runs."""
    fn = getattr(cls, name)

    def wrapped(self, *args, **kwargs):
        out = fn(self, *args, **kwargs)
        outputs.append(np.array(out))
        return out

    setattr(cls, name, wrapped)
    try:
        yield outputs
    finally:
        setattr(cls, name, fn)


@contextlib.contextmanager
def replaying(cls, name: str, outputs: list):
    """``cls.name`` returns ``outputs`` in order instead of running: the JAX
    engine fed the port's driver decisions, so that everything after the
    driver is compared exactly."""
    fn = getattr(cls, name)
    queue = list(outputs)
    setattr(cls, name, lambda self, *args, **kwargs: queue.pop(0))
    try:
        yield
    finally:
        setattr(cls, name, fn)
    assert not queue, "the engine asked the driver for fewer results than were recorded"
