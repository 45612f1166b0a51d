"""The port stands alone: ``univs_tpu_torch`` and every submodule import
with JAX and the repository's ``tools`` blocked, no module of the package
imports ``univs_tpu``, ``jax``, ``flax`` or ``tools``, and the entry
points refuse to run on the CPU unless the caller asks for it."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import univs_tpu_torch
from univs_tpu_torch.config import tiny_test_config
from univs_tpu_torch.inference.driver import EntityDriver
from univs_tpu_torch.inference.fast_vis import (FastVISDriver, FastVPSDriver, MDQEVISDriver,
                                                SemanticExtractionDriver)
from univs_tpu_torch.inference.image import ImageDriver
from univs_tpu_torch.inference.serving import BatchedVISServer
from univs_tpu_torch.models import univs as univs_models
from univs_tpu_torch.ops import kernels

torch.set_num_threads(1)

PKG = pathlib.Path(univs_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "univs_tpu", "tools")


def test_package_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        import univs_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(univs_tpu_torch.__path__, "univs_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        assert not any(k.split(".")[0] in {FORBIDDEN!r} and sys.modules[k] is not None
                       for k in sys.modules)
        print(len(mods))
    """)
    root = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")))
def test_no_forbidden_imports(path):
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_chip_smoke_and_the_training_modules_stand_alone():
    """``chip_smoke.py`` and the training modules (data parallelism, stage-3
    long video) import nothing of the JAX package, JAX, flax or ``tools``,
    at module level or inside a function."""
    paths = (PKG.parent / "chip_smoke.py", PKG / "parallel" / "ddp.py",
             PKG / "parallel" / "long_video.py", PKG / "parallel" / "train_state.py")
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in FORBIDDEN for n in names), (path.name, names)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_refuse_cpu_without_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EntityDriver(cfg, num_classes=2, capacity=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        univs_models.build_pixel_decoder(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        univs_models.build_decoder(cfg, device="cuda")


def test_evaluate_dataset_refuses_cpu_without_request(monkeypatch, tmp_path):
    """The engine resolves its device before it reads a dataset, and every
    per-task evaluator builds its drivers there."""
    from univs_tpu_torch import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("UNIVS_TPU_DATA_ROOT", str(tmp_path))  # holds no dataset
    cfg = tiny_test_config()
    bank = np.zeros((2, cfg.decoder.clip_cls_emb_dim), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.evaluate_dataset(cfg, None, "ytvis_2019_val", bank)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine._eval_vos(cfg, None, [], None, bank)
    with pytest.warns(RuntimeWarning):  # no video: JAX's NaN metrics
        out = engine._eval_vss(cfg, None, [], None, bank, device="cpu")
    assert sorted(out) == ["fps", "mAcc", "mIoU", "mVC"]


def test_train_draws_refuse_cpu_without_request(monkeypatch):
    """The train step draws on its key's device: the key is made on the
    card unless the caller asks for the CPU."""
    from univs_tpu_torch.utils.draws import make_key

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_key(0)
    key = make_key(0, device="cpu")
    assert key.source.device.type == "cpu" and key.uniform((2,)).device.type == "cpu"


@pytest.mark.parametrize("make", [
    lambda cfg, **kw: FastVISDriver(cfg, **kw),
    lambda cfg, **kw: MDQEVISDriver(cfg, **kw),
    lambda cfg, **kw: FastVPSDriver(cfg, **kw),
    lambda cfg, **kw: SemanticExtractionDriver(cfg, **kw),
    lambda cfg, **kw: ImageDriver(cfg, num_classes=2, **kw),
    lambda cfg, **kw: BatchedVISServer(cfg, num_classes=2, capacity=2, **kw),
], ids=["fast_vis", "mdqe", "fast_vps", "semantic_extraction", "image", "batched_server"])
def test_fast_and_image_drivers_refuse_cpu_without_request(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(cfg)
    driver = make(cfg, device="cpu")
    assert driver.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in driver.model.parameters())


def test_cpu_tensors_take_the_plain_laws(monkeypatch):
    """On CPU tensors the encoder runs the plain laws: no kernel is built
    or loaded, and the launch counts stay at 0."""
    cfg = tiny_test_config()
    pd = univs_models.build_pixel_decoder(cfg, device="cpu")
    rng = np.random.RandomState(0)
    feats = {k: torch.as_tensor(rng.randn(1, 64 // s, 96 // s, c).astype(np.float32))
             for k, s, c in (("res2", 4, 256), ("res3", 8, 512), ("res4", 16, 1024),
                             ("res5", 32, 2048))}
    def no_kernels(name):
        raise AssertionError(f"kernel {name} requested for CPU tensors")

    monkeypatch.setattr(kernels, "lib", no_kernels)
    kernels.reset_launch_counts()
    with torch.no_grad():
        mf, _, _, ms = pd(feats)
    assert tuple(mf.shape) == (1, 16, 24, cfg.pixel_decoder.mask_dim)
    assert bool(torch.isfinite(mf).all())
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
