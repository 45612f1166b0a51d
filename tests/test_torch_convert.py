"""The port's weight intake against the JAX package's on the same inputs:
every converter of ``utils/convert.py`` and ``utils/convert_univs.py``
leaf for leaf and bit for bit (both are numpy), on reference-named
checkpoints made from the port's own module shapes (``torch_convert_util``)
at full R50 / pixel-decoder / decoder width, and for Swin-T, PVTv2-b0, the
VL pixel decoder and the CLIP text tower at small width; the converted
tree against JAX's model tree (``jax.eval_shape``, no compile) with
nothing missing, extra or misshapen; ``_strip_prefixes`` on EMA and
renamed keys; ``load_params`` on each format; ``load_category_bank``'s
search order and its seeded bank."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_convert_util import (clip_text_reference, meta_shapes,
                                pixel_decoder_reference, pvt_reference, random_arrays,
                                resnet_reference, save_reference, swin_reference,
                                univs_reference, with_teacher)
from univs_tpu.config import UniVSConfig as JaxUniVSConfig
from univs_tpu.models.univs import UniVSModel as JaxUniVSModel
from univs_tpu.structures import TextPrompts as JaxTextPrompts
from univs_tpu.utils import checkpoint as jax_checkpoint
from univs_tpu.utils import convert as jax_convert
from univs_tpu.utils import convert_univs as jax_convert_univs
from univs_tpu_torch.config import BackboneConfig, UniVSConfig, tiny_test_config
from univs_tpu_torch.models.backbones.resnet import ResNet, build_backbone
from univs_tpu_torch.models.clip_text import ClipTextEncoder
from univs_tpu_torch.models.pixel_decoder_vl import MSDeformAttnPixelDecoderVL
from univs_tpu_torch.models.univs import UniVSModel, build_model
from univs_tpu_torch.parallel.train_state import TrainState
from univs_tpu_torch.utils import checkpoint, convert, convert_univs
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)


def assert_same_tree(got, want, path=""):
    """The same keys at every level; every leaf the same dtype, shape and
    bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
    assert np.array_equal(g, w), path


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and np.array_equal(g, w), k


def jax_tree_shapes(cfg):
    """The JAX model's param tree, as shapes (traced, not compiled)."""
    model, K = JaxUniVSModel(cfg), 4
    ce = jnp.zeros((K, cfg.decoder.clip_cls_emb_dim))
    tp = JaxTextPrompts(embs=ce[None, :, None, :], valid=jnp.ones((1, K), bool))
    return jax.eval_shape(lambda r: model.init(
        {"params": r}, jnp.zeros((1, 2, 64, 64, 3)), jnp.arange(2)[None], task="detection",
        text_prompts=tp, cls_emb=ce)["params"], jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def full():
    """A full-width UniVS-R50 checkpoint (default config: pixel decoder
    C=256, 6 layers; decoder 200 queries, 9 layers), reference-named, and
    the port state_dict it was made from."""
    sd = random_arrays(meta_shapes(lambda: UniVSModel(UniVSConfig())), seed=0)
    return sd, univs_reference(sd)


def test_univs_checkpoint_full_width_equals_jax(full):
    sd, ref = full
    want = jax_convert_univs.convert_univs_checkpoint(dict(ref))
    got = convert_univs.convert_univs_checkpoint(dict(ref))
    assert_same_tree(got, want)
    # every leaf of JAX's model tree filled, none extra, each of its shape;
    # and the tree is the port's state_dict the checkpoint came from
    shapes = jax_tree_shapes(JaxUniVSConfig())
    assert convert.report_unconverted(shapes, got) == []
    assert convert.report_unconverted(got, shapes) == []
    assert len(jax.tree.leaves(shapes)) == len(jax.tree.leaves(got)) == 740
    assert_same_state(state_dict_from_flax(got), sd)


def test_pixel_decoder_and_decoder_full_width_equal_jax(full):
    ref = convert_univs._strip_prefixes(full[1])  # static_query -> query_feat
    assert_same_tree(convert_univs.convert_pixel_decoder(ref, 6),
                     jax_convert_univs.convert_pixel_decoder(ref, 6))
    assert_same_tree(convert_univs.convert_decoder(ref, 9, 256),
                     jax_convert_univs.convert_decoder(ref, 9, 256))
    p = "sem_seg_head.predictor.transformer_cross_attention_layers.3.multihead_attn"
    assert_same_tree(convert.split_inproj(ref, p), jax_convert.split_inproj(ref, p))


@pytest.mark.parametrize("naming", ["d2", "torchvision"])
@pytest.mark.parametrize("depth", [50, 101])
def test_resnet_equals_jax(naming, depth):
    sd = random_arrays(meta_shapes(lambda: ResNet(depth=depth)), seed=depth)
    prefix = "backbone." if naming == "d2" else ""
    ref = resnet_reference(sd, naming, prefix)
    got = convert.convert_resnet(ref, depth=depth)
    assert_same_tree(got, jax_convert.convert_resnet(ref, depth=depth))
    assert_same_state(state_dict_from_flax(got), sd)


def test_swin_tiny_equals_jax():
    """Swin-T bare and under ``backbone.``; inside a UniVS checkpoint the
    converter is chosen from the keys and the depths read from them."""
    sd = random_arrays(meta_shapes(lambda: build_backbone(BackboneConfig(name="swin_tiny"))), 3)
    for prefix in ("", "backbone."):
        ref = swin_reference(sd, prefix)
        got = convert.convert_swin(ref, depths=(2, 2, 6, 2))
        assert_same_tree(got, jax_convert.convert_swin(ref, depths=(2, 2, 6, 2)))
        assert_same_state(state_dict_from_flax(got), sd)
    cfg = dataclasses.replace(tiny_test_config(), backbone=BackboneConfig(name="swin_tiny"))
    full_sd = random_arrays(meta_shapes(lambda: UniVSModel(cfg)), 4)
    ref = univs_reference(full_sd)
    got = convert_univs.convert_univs_checkpoint(dict(ref))
    assert_same_tree(got, jax_convert_univs.convert_univs_checkpoint(dict(ref)))
    assert_same_state(state_dict_from_flax(got), full_sd)


def test_pvt_b0_equals_jax():
    sd = random_arrays(meta_shapes(lambda: build_backbone(BackboneConfig(name="pvt_v2_b0"))), 5)
    ref = pvt_reference(sd)
    got = convert_univs.convert_pvt(ref, depths=(2, 2, 2, 2))
    assert_same_tree(got, jax_convert_univs.convert_pvt(ref, depths=(2, 2, 2, 2)))
    assert_same_state(state_dict_from_flax(got), sd)


def test_vl_pixel_decoder_equals_jax():
    channels = {"res2": 24, "res3": 48, "res4": 96, "res5": 192}
    sd = random_arrays(meta_shapes(lambda: MSDeformAttnPixelDecoderVL(
        channels, hidden_dim=32, mask_dim=32, num_layers=2, num_heads=4, num_points=2,
        ffn_dim=64, lang_dim=16)), 6)
    ref = pixel_decoder_reference(sd)
    got = convert_univs.convert_pixel_decoder_vl(ref, num_layers=2)
    assert_same_tree(got, jax_convert_univs.convert_pixel_decoder_vl(ref, num_layers=2))
    assert_same_state(state_dict_from_flax(got), sd)


def test_clip_text_equals_jax():
    sd = random_arrays(meta_shapes(lambda: ClipTextEncoder(
        embed_dim=24, vocab_size=300, width=32, heads=2, num_layers=3)), 7)
    ref = clip_text_reference(sd)
    got = convert.convert_clip_text(ref, num_layers=3, width=32)
    assert_same_tree(got, jax_convert.convert_clip_text(ref, num_layers=3, width=32))
    assert_same_state(state_dict_from_flax(got), sd)


def test_flatten_and_report_equal_jax():
    rng = np.random.RandomState(8)
    state = {"model": {"a.weight": torch.as_tensor(rng.randn(3, 2).astype(np.float32)),
                       "b": np.arange(4)}}
    assert_same_tree(convert.flatten_torch(state), jax_convert.flatten_torch(state))
    assert_same_tree(convert.flatten_torch(state["model"]), jax_convert.flatten_torch(state["model"]))
    tree = {"x": {"kernel": np.zeros((2, 3)), "bias": np.zeros(3)}, "y": np.zeros(4)}
    partial = {"x": {"kernel": np.zeros((3, 2))}}
    got = convert.report_unconverted(tree, partial, "m")
    assert got == jax_convert.report_unconverted(tree, partial, "m")
    assert got == ["m/x/kernel SHAPE (2, 3) vs (3, 2)", "m/x/bias", "m/y"]


STRIP_CASES = {
    "plain": {"a.w": 1, "sem_seg_head.predictor.static_query.weight": 2},
    "teacher": {"a.w": 1, "teacher.a.w": 3, "teacher.static_query": 4, "static_query": 5},
    "model_teacher": {"a.w": 1, "model_teacher.a.w": 6, "b": 7},
    "teacher_only": {"teacher.a.w": 8},
}


@pytest.mark.parametrize("case", sorted(STRIP_CASES))
@pytest.mark.parametrize("prefer_ema", [True, False])
def test_strip_prefixes_equals_jax(case, prefer_ema):
    sd = {k: np.asarray(v, np.float32) for k, v in STRIP_CASES[case].items()}
    got = convert_univs._strip_prefixes(sd, prefer_ema)
    assert_same_tree(got, jax_convert_univs._strip_prefixes(sd, prefer_ema))
    assert not any("static_query" in k for k in got) or got is sd
    if case == "teacher" and prefer_ema:
        assert sorted(got) == ["a.w", "query_feat"] and float(got["a.w"]) == 3.0
    if case == "teacher" and not prefer_ema:
        assert sorted(got) == ["a.w", "query_feat"] and float(got["query_feat"]) == 5.0


def test_max_index_equals_jax():
    sd = {"x.layers.0.a": 0, "x.layers.11.b": 0, "x.layers.3": 0, "x.layersX.7": 0, "y.1": 0}
    for prefix in ("x.layers.", "x.", "z."):
        assert convert_univs._max_index(sd, prefix) == jax_convert_univs._max_index(sd, prefix)
    assert convert_univs._max_index(sd, "x.layers.") == 12


# ---------------------------------------------------------------------------
# load_params
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A tiny reference-named EMA checkpoint: the student from the port's
    seeded init (seed 0) with ``static_query``, the teacher (seed 1) under
    ``teacher.``; and the teacher's state_dict."""
    cfg = tiny_test_config()
    student = build_model(cfg, None, seed=0, device="cpu").state_dict()
    teacher = build_model(cfg, None, seed=1, device="cpu").state_dict()
    path = tmp_path_factory.mktemp("ckpt") / "univs_tiny_ema.pth"
    save_reference(path, with_teacher(univs_reference(student), univs_reference(teacher)))
    return str(path), {k: v.numpy() for k, v in teacher.items()}


def test_load_params_full_reference_pth(tiny_checkpoint):
    """The EMA teacher's weights, strictly loadable, equal to the JAX
    package's ``load_params`` through the weight bridge."""
    path, teacher = tiny_checkpoint
    got = checkpoint.load_params(path, tiny_test_config())
    assert_same_state(got, teacher)
    assert_same_state(got, state_dict_from_flax(jax_checkpoint.load_params(path)))
    model = build_model(tiny_test_config(), got, device="cpu")
    assert_same_state({k: v.numpy() for k, v in model.state_dict().items()}, teacher)


def test_load_params_raw_pth_and_npz(tmp_path):
    rng = np.random.RandomState(9)
    raw = {"conv1.weight": rng.randn(4, 3, 1, 1).astype(np.float32),
           "fc.bias": rng.randn(5).astype(np.float32)}
    pth = tmp_path / "raw.pth"
    torch.save({"model": {k: torch.as_tensor(v) for k, v in raw.items()}}, pth)
    assert_same_tree(checkpoint.load_params(str(pth)), jax_checkpoint.load_params(str(pth)))
    assert_same_tree(checkpoint.load_params(str(pth)), raw)
    npz = tmp_path / "w.npz"
    np.savez(npz, **raw)
    assert_same_tree(checkpoint.load_params(str(npz)), jax_checkpoint.load_params(str(npz)))


def test_load_params_reads_the_trainers_files(tmp_path):
    """``state_*`` (``save_checkpoint``) and ``ckpt_final`` (``save_params``):
    the float32 masters."""
    rng = np.random.RandomState(10)
    masters = {"a.weight": torch.as_tensor(rng.randn(3, 2).astype(np.float32)),
               "b": torch.as_tensor(rng.randn(4).astype(np.float32))}
    zeros = {k: torch.zeros_like(v) for k, v in masters.items()}
    state = TrainState(step=7, params=masters, mu=zeros, nu=zeros, ema_params=zeros)
    checkpoint.save_checkpoint(str(tmp_path / "state_7"), state)
    checkpoint.save_params(str(tmp_path / "ckpt_final"), state)
    for name in ("state_7", "ckpt_final"):
        got = checkpoint.load_params(str(tmp_path / name))
        assert sorted(got) == sorted(masters)
        for k, v in masters.items():
            assert got[k].dtype == torch.float32 and torch.equal(got[k], v)


def test_load_params_refuses_directories_and_unknown_files(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="JAX"):
        checkpoint.load_params(str(tmp_path / "orbax"))
    (tmp_path / "w.bin").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        checkpoint.load_params(str(tmp_path / "w.bin"))


# ---------------------------------------------------------------------------
# load_category_bank
# ---------------------------------------------------------------------------


def test_category_bank_search_order(tmp_path, monkeypatch, caplog):
    rng = np.random.RandomState(11)
    env_bank = rng.randn(6, 640).astype(np.float32)
    np.save(tmp_path / "env.npy", env_bank)
    explicit = rng.randn(5, 640).astype(np.float32)
    torch.save(torch.as_tensor(explicit), tmp_path / "explicit.pth")
    artifact = np.load(checkpoint.os.path.join(
        checkpoint.os.path.dirname(checkpoint.os.path.dirname(checkpoint.os.path.dirname(
            checkpoint.os.path.abspath(checkpoint.__file__)))),
        "artifacts", "combined_datasets_cls_emb_rn50x4_randinit.npy"))

    def both(*args):
        got = checkpoint.load_category_bank(*args)
        assert_same_tree(got, jax_checkpoint.load_category_bank(*args))
        return got

    monkeypatch.setenv("UNIVS_TPU_CLS_BANK", str(tmp_path / "env.npy"))
    assert_same_tree(both(None, 3938, 640), env_bank)
    assert_same_tree(both(str(tmp_path / "explicit.pth"), 3938, 640), explicit)
    monkeypatch.delenv("UNIVS_TPU_CLS_BANK")
    with caplog.at_level(logging.WARNING):
        assert_same_tree(both(None, 3938, 640), artifact.astype(np.float32))
    assert "RANDOM-INIT artifact" in caplog.text
    # a width the artifact does not have: the seeded random bank
    seeded = both(None, 3938, 16)
    assert seeded.shape == (3938, 16) and np.allclose(np.linalg.norm(seeded, axis=-1), 1.0)
    assert_same_tree(both("", 40, 16, 3), jax_checkpoint.load_category_bank(None, 40, 16, 3))
