"""The port's RLE module against the JAX package's: the native encoder
(``univs_tpu_torch/csrc/rle.cpp`` built into ``build/rle/``) and its numpy
law give byte-identical dicts to ``univs_tpu.utils.rle`` on seeded masks,
``decode`` / ``area`` / ``intersection`` / ``iou`` equal JAX's, and the
build writes nothing beside the sources."""

import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from univs_tpu.utils import rle as jax_rle
from univs_tpu_torch.utils import rle

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _fragmented(h, w, seed):
    """Blobs plus salt: many short runs in every column."""
    rng = np.random.RandomState(seed)
    m = (rng.rand(h, w) > 0.97).astype(np.uint8)
    for _ in range(12):
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(1, h // 3 + 2), x:x + rng.randint(1, w // 3 + 2)] ^= 1
    return m


def _cases():
    one = np.zeros((9, 13), np.uint8)
    one[4, 7] = 1
    starts_with_one = np.zeros((6, 5), np.uint8)
    starts_with_one[:3, 0] = 1
    return {
        "empty": np.zeros((16, 24), np.uint8),
        "full": np.ones((16, 24), np.uint8),
        "single_pixel": one,
        "odd_hw": _fragmented(37, 53, 1),
        "starts_with_one": starts_with_one,
        "bool_input": _fragmented(20, 30, 2).astype(bool),
        "fragmented_640x960": _fragmented(640, 960, 3),
    }


CASES = _cases()


def test_native_backend_builds_under_build_dir():
    assert rle.backend() == "native"
    lib = pathlib.Path(rle.LIB_PATH)
    assert lib.is_file() and lib.parent == REPO / "build" / "rle"


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_equals_jax(name):
    m = CASES[name]
    want = jax_rle.encode(m)
    assert rle.encode(m) == want
    assert rle.encode_numpy(m) == want
    np.testing.assert_array_equal(rle.decode(want), np.asarray(m, np.uint8))
    np.testing.assert_array_equal(rle.decode_numpy(want), np.asarray(m, np.uint8))
    assert rle.area(want) == rle.area_numpy(want) == jax_rle.area(want) == int(m.sum())


@pytest.mark.parametrize("as_bytes", [False, True], ids=["str", "bytes"])
def test_area_intersection_iou_equal_jax(as_bytes):
    masks = [_fragmented(41, 67, s) for s in range(4)] + [np.zeros((41, 67), np.uint8)]
    rles = [jax_rle.encode(m) for m in masks]
    if as_bytes:
        rles = [{"size": r["size"], "counts": r["counts"].encode("ascii")} for r in rles]
    for a, ma in zip(rles, masks):
        np.testing.assert_array_equal(rle.decode(a), ma)
        assert rle.area(a) == rle.area_numpy(a) == jax_rle.area(a)
        for b, mb in zip(rles, masks):
            inter = int((ma & mb).sum())
            assert rle.intersection(a, b) == rle.intersection_numpy(a, b) == inter
            assert rle.intersection(a, b) == jax_rle.intersection(a, b)
            assert rle.iou(a, b) == jax_rle.iou(a, b)


def test_encode_mask_batch_equals_jax():
    masks = np.stack([_fragmented(33, 45, s) for s in range(3)])
    assert rle.encode_mask_batch(masks) == jax_rle.encode_mask_batch(masks)


def _isolated_copy(root: pathlib.Path, source: str) -> pathlib.Path:
    """A tree with the port's ``utils/rle.py`` and the given ``csrc/rle.cpp``
    at their places, nothing built."""
    pkg = root / "univs_tpu_torch"
    (pkg / "utils").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    for p in (pkg / "__init__.py", pkg / "utils" / "__init__.py"):
        p.write_text("")
    shutil.copy(REPO / "univs_tpu_torch" / "utils" / "rle.py", pkg / "utils" / "rle.py")
    (pkg / "csrc" / "rle.cpp").write_text(source)
    return pkg


_PROBE = textwrap.dedent("""
    import logging, sys
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout)
    import numpy as np
    from univs_tpu_torch.utils import rle
    m = np.zeros((5, 7), np.uint8); m[1:3, 2:6] = 1
    print(rle.backend(), rle.encode(m)["counts"])
""")


def _probe(root: pathlib.Path) -> str:
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_first_use_builds_into_build_and_writes_nothing_beside_the_source(tmp_path):
    pkg = _isolated_copy(tmp_path, (REPO / "univs_tpu_torch" / "csrc" / "rle.cpp").read_text())
    before = sorted(p.name for p in (pkg / "csrc").iterdir())
    out = _probe(tmp_path)
    m = np.zeros((5, 7), np.uint8)
    m[1:3, 2:6] = 1
    assert out.split() == ["native", jax_rle.encode(m)["counts"]]
    assert (tmp_path / "build" / "rle" / "librle.so").is_file()
    assert sorted(p.name for p in (pkg / "csrc").iterdir()) == before == ["rle.cpp"]
    assert not (tmp_path / "csrc").exists()
    assert sorted(p.name for p in (tmp_path / "build" / "rle").iterdir()) == ["librle.so"]


def test_failed_build_warns_with_the_compiler_error_and_takes_numpy(tmp_path):
    _isolated_copy(tmp_path, "this is not C++;\n")
    out = _probe(tmp_path)
    m = np.zeros((5, 7), np.uint8)
    m[1:3, 2:6] = 1
    assert "RLE takes the numpy law" in out and "error" in out
    assert out.split()[-2:] == ["numpy", jax_rle.encode(m)["counts"]]
    assert not (tmp_path / "build" / "rle" / "librle.so").exists()
