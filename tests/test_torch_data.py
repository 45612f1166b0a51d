"""The port's data layer against the JAX package's on a synthetic tree
(JSON + PNG frames under ``UNIVS_TPU_DATA_ROOT``): the registry,
``load_dataset``, ``segmentation_to_mask`` (compressed and uncompressed
RLE, polygons), ``EvalVideoMapper``, the augment samplers and
``TrainVideoMapper`` under one seed (clips, masks, transforms), the
train samples through the port's ``collate_train_batch``, raw-video
decoding, and the eval transform's identity resize without cv2."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from univs_tpu.data import augment as j_augment, datasets as j_datasets, mapper as j_mapper
from univs_tpu.data import video as j_video, ytvis as j_ytvis
from univs_tpu.data.loader import collate_train_batch as j_collate
from univs_tpu.utils import rle as jax_rle
from univs_tpu_torch.data import augment as t_augment, datasets as t_datasets, mapper as t_mapper
from univs_tpu_torch.data import video as t_video, ytvis as t_ytvis
from univs_tpu_torch.data.loader import collate_train_batch

torch.set_num_threads(1)


# (dataset name, its json and image root in the registry, video sizes)
TREES = {
    "ytvis_2019_val": ((48, 64), (64, 96)),
    "sot_davis17_val": ((40, 56),),
    "rvos-refdavis-val-0": ((48, 64),),
    "coco_panoptic_val": ((56, 72), (56, 72)),
}


def _segmentations(rng, H, W, V, kind):
    yy, xx = np.mgrid[:H, :W]
    cy, cx = rng.uniform(0.3, 0.7) * H, rng.uniform(0.3, 0.7) * W
    out = []
    for f in range(V):
        if f == 1 and kind != "poly":
            out.append(None)
            continue
        m = (((yy - cy - f) / (0.2 * H)) ** 2 + ((xx - cx + f) / (0.25 * W)) ** 2 <= 1)
        m = m.astype(np.uint8)
        if kind == "rle":
            out.append(jax_rle.encode(m))
        elif kind == "uncompressed":
            flat = m.reshape(-1, order="F")
            runs = np.diff(np.flatnonzero(np.diff(np.r_[-1, flat.astype(int), -1]) != 0)).tolist()
            out.append({"size": [H, W], "counts": ([0] if flat[0] else []) + runs})
        else:
            x0, y0 = cx - 0.2 * W + f, cy - 0.15 * H
            out.append([[x0, y0, x0 + 0.4 * W, y0, x0 + 0.3 * W, y0 + 0.3 * H, x0, y0 + 0.25 * H]])
    return out


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    for name, sizes in TREES.items():
        spec = j_datasets.get_spec(name)
        rng = np.random.RandomState(len(name))
        videos, anns = [], []
        V = 1 if spec.evaluator_type == "coco" else 4
        for vid, (H, W) in enumerate(sizes, start=1):
            files = []
            for f in range(V):
                rel = f"video{vid}/{f:05d}.png"
                os.makedirs(root / spec.image_root / f"video{vid}", exist_ok=True)
                Image.fromarray(rng.randint(0, 256, (H, W, 3)).astype(np.uint8)).save(
                    root / spec.image_root / rel)
                files.append(rel)
            video = {"id": vid, "file_names": files, "height": H, "width": W, "length": V}
            if spec.has_expression:
                video["expressions"] = ["the left one", "the other one"]
                video["exp_obj_ids"] = [2 * vid, 2 * vid + 1]
            videos.append(video)
            for k, kind in enumerate(("rle", "uncompressed", "poly")):
                anns.append({"id": 2 * vid + k, "video_id": vid, "category_id": (5, 9, 2)[k],
                             "iscrowd": int(k == 2),
                             "segmentations": _segmentations(rng, H, W, V, kind)})
        data = {"videos": videos, "annotations": anns,
                "categories": [{"id": c, "name": str(c)} for c in (2, 5, 9)]}
        os.makedirs(os.path.dirname(root / spec.json_path), exist_ok=True)
        (root / spec.json_path).write_text(json.dumps(data))
    return str(root)


def _same(got, want, where="value"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif dataclasses.is_dataclass(want):
        _same(dataclasses.asdict(got), dataclasses.asdict(want), where)
    else:
        assert got == want, (where, got, want)


def test_registry_equals_jax(monkeypatch, tmp_path):
    assert t_datasets.list_datasets() == j_datasets.list_datasets()
    for name in j_datasets.list_datasets():
        _same(dataclasses.asdict(t_datasets.get_spec(name)),
              dataclasses.asdict(j_datasets.get_spec(name)), name)
        assert t_datasets.get_spec(name).thing_ids == j_datasets.get_spec(name).thing_ids
    monkeypatch.delenv("UNIVS_TPU_DATA_ROOT", raising=False)
    assert t_datasets.data_root() == j_datasets.data_root() == "datasets"
    monkeypatch.setenv("UNIVS_TPU_DATA_ROOT", str(tmp_path))
    assert t_datasets.data_root() == j_datasets.data_root() == str(tmp_path)


@pytest.mark.parametrize("name", sorted(TREES))
def test_load_dataset_and_eval_mapper_equal_jax(name, data_root, monkeypatch):
    monkeypatch.setenv("UNIVS_TPU_DATA_ROOT", data_root)
    want = j_datasets.load_dataset(name)
    got = t_datasets.load_dataset(name)
    _same(got, want)
    assert len(got) == len(TREES[name])
    for rec in got:
        for ann in rec["annotations"]:
            for segm in ann["segmentations"]:
                _same(t_ytvis.segmentation_to_mask(segm, rec["height"], rec["width"]),
                      j_ytvis.segmentation_to_mask(segm, rec["height"], rec["width"]))
    kw = dict(short=64, max_size=128, size_divisibility=32)
    for t_rec, j_rec in zip(got, want):
        s, w = t_mapper.EvalVideoMapper(**kw)(t_rec), j_mapper.EvalVideoMapper(**kw)(j_rec)
        _same({k: v for k, v in s.items() if k != "record"},
              {k: v for k, v in w.items() if k != "record"})


def test_train_mapper_equals_jax_and_feeds_collate(data_root, monkeypatch):
    monkeypatch.setenv("UNIVS_TPU_DATA_ROOT", data_root)
    records = (t_datasets.load_dataset("ytvis_2019_val")
               + t_datasets.load_dataset("coco_panoptic_val"))
    jrecords = (j_datasets.load_dataset("ytvis_2019_val")
                + j_datasets.load_dataset("coco_panoptic_val"))
    cfg = dict(num_frames=3, sampling_interval=2, image_size=96, max_instances=4)
    tm = t_mapper.TrainVideoMapper(t_mapper.TrainMapperConfig(**cfg), seed=5)
    jm = j_mapper.TrainVideoMapper(j_mapper.TrainMapperConfig(**cfg), seed=5)
    samples, jsamples = [], []
    for _ in range(2):
        for rec, jrec in zip(records, jrecords):  # videos, then pseudo-videos of stills
            s, w = tm(rec), jm(jrec)
            _same(s, w)
            if s is not None:
                samples.append(s)
                jsamples.append(w)
    assert len(samples) >= 4 and any(s["valid"].sum() >= 2 for s in samples)
    bank = np.random.RandomState(0).randn(6, 16).astype(np.float32)
    bank_valid = np.ones(6, bool)
    batch = collate_train_batch(samples[:3], bank, bank_valid, prompt_slots=5)
    jbatch = j_collate(jsamples[:3], bank, bank_valid, prompt_slots=5)
    assert tuple(batch.images.shape) == (3, 3, 96, 96, 3)
    for field in ("images", "frame_indices", "prompt_category_embs", "prompt_category_valid"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      np.asarray(getattr(jbatch, field)))
    for field in ("labels", "ids", "masks", "valid", "prompt_obj_ids"):
        np.testing.assert_array_equal(getattr(batch.targets, field).numpy(),
                                      np.asarray(getattr(jbatch.targets, field)))


@pytest.mark.parametrize("pseudo", [False, True], ids=["video", "pseudo_video"])
def test_augment_samplers_equal_jax(pseudo):
    for mod in (t_augment, j_augment):
        assert mod.TrainAugConfig().image_size == 1024
    cfg = dict(image_size=96, color_jitter=pseudo, rotation=pseudo)
    img = np.random.RandomState(1).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    mask = (np.random.RandomState(2).rand(50, 70) > 0.6).astype(np.uint8)
    for seed in range(3):
        got = t_augment.sample_clip_transforms(np.random.RandomState(seed), (50, 70), 3,
                                               t_augment.TrainAugConfig(**cfg))
        want = j_augment.sample_clip_transforms(np.random.RandomState(seed), (50, 70), 3,
                                                j_augment.TrainAugConfig(**cfg))
        _same(got, want)
        for g, w in zip(got, want):
            _same(g.apply_image(img), w.apply_image(img))
            _same(g.apply_mask(mask), w.apply_mask(mask))
        lsj = t_augment.sample_lsj_transform(np.random.RandomState(seed), (50, 70), 96)
        jlsj = j_augment.sample_lsj_transform(np.random.RandomState(seed), (50, 70), 96)
        _same(lsj, jlsj)
        _same(lsj.apply_image(img), jlsj.apply_image(img))
    for hw in ((48, 64), (64, 96), (480, 854)):
        t = t_augment.resize_shortest_edge(hw, 64, 128)
        j = j_augment.resize_shortest_edge(hw, 64, 128)
        _same(t, j)
        assert t_augment.transformed_image_size(t, hw) == j_augment.transformed_image_size(j, hw)


def test_identity_resize_skips_cv2_and_equals_it():
    """At scale 1.0 the eval transform returns the frame as OpenCV's resize
    would (a copy), bit for bit, and imports no cv2."""
    assert (t_augment.INTER_NEAREST, t_augment.INTER_LINEAR) == (cv2.INTER_NEAREST,
                                                                 cv2.INTER_LINEAR)
    rng = np.random.RandomState(3)
    for hw in ((64, 96), (640, 960)):
        img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        mask = (rng.rand(*hw) > 0.5).astype(np.uint8)
        t = t_augment.resize_shortest_edge(hw, min(hw))
        j = j_augment.resize_shortest_edge(hw, min(hw))
        assert t.scale == 1.0
        np.testing.assert_array_equal(t.apply_image(img), j.apply_image(img))
        np.testing.assert_array_equal(t.apply_mask(mask), j.apply_mask(mask))
        np.testing.assert_array_equal(
            t.apply_image(img), cv2.resize(img, hw[::-1], interpolation=cv2.INTER_LINEAR))
    code = textwrap.dedent("""
        import sys
        sys.modules["cv2"] = None
        import numpy as np
        from univs_tpu_torch.data.augment import resize_shortest_edge
        img = np.arange(64 * 96 * 3, dtype=np.uint8).reshape(64, 96, 3)
        out = resize_shortest_edge((64, 96), 64).apply_image(img)
        assert out.dtype == np.uint8 and (out == img).all()
        try:
            resize_shortest_edge((48, 64), 64).apply_image(img[:48, :64])
        except ImportError:
            print("needs cv2 only to resize")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "needs cv2 only to resize"


def test_read_video_frames_equal_jax(tmp_path):
    path = str(tmp_path / "clip.mp4")
    h, w, n = 48, 64, 6
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (w, h))
    assert wr.isOpened()
    rng = np.random.RandomState(0)
    for i in range(n):
        frame = np.full((h, w, 3), i * 30, np.uint8)
        frame[8:20, 10:30] = rng.randint(0, 255, (12, 20, 3), np.uint8)
        wr.write(frame)
    wr.release()
    assert t_video.video_num_frames(path) == j_video.video_num_frames(path) == n
    for idx in (None, [1, 4, 100], [0, 2, 2, 2], [3, 0]):
        _same(t_video.read_video_frames(path, idx), j_video.read_video_frames(path, idx))
    rec = {"video_path": path, "video_id": 3, "dataset_name": "custom_videos", "task": "detection"}
    kw = dict(short=32, max_size=64, size_divisibility=16)
    s, want = t_mapper.EvalVideoMapper(**kw)(rec), j_mapper.EvalVideoMapper(**kw)(rec)
    _same({k: v for k, v in s.items() if k != "record"},
          {k: v for k, v in want.items() if k != "record"})
