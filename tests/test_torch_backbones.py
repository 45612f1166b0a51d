"""Parity of the port's Swin and PVTv2 backbones against the JAX package's
on the CPU, in float32, with the flax weights (perturbed away from their
init, so every LayerNorm, bias table and bias matters) bridged by
``state_dict_from_flax`` + ``load_state_dict_strict``: res2..res5 within
1e-4 of each output's largest magnitude, at an input (62 x 74) whose
patch embedding pads (flax "SAME") and whose every stage map needs
window padding (Swin) or is no multiple of 7 (PVT's 7x7 pool).  Also:
the shift mask and the relative-position index equal JAX's arrays, the
backbone factory's names, float32-held parameters after a bf16 build,
and the encoder geometry (C=256, 8 heads, D=32) that kernels A and C
accept for every backbone variant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.models.backbones import pvt as jpvt
from univs_tpu.models.backbones import swin as jswin
from univs_tpu_torch.config import BackboneConfig, UniVSConfig
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.models import univs as univs_models
from univs_tpu_torch.models.backbones import pvt, swin
from univs_tpu_torch.models.backbones.resnet import build_backbone
from univs_tpu_torch.models.pixel_decoder import MSDeformAttnLayer
from univs_tpu_torch.models.pixel_decoder_vl import MSDeformAttnPixelDecoderVL
from univs_tpu_torch.utils.weights import load_state_dict_strict, state_dict_from_flax

torch.set_num_threads(1)

N, H, W = 2, 62, 74
SWIN_TINY = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4))
PVT_TINY = dict(dims=(16, 32, 40, 64), depths=(1, 2, 1, 1), num_heads=(1, 2, 5, 8))
ALL_NAMES = ["resnet50", *swin.VARIANTS, *pvt.VARIANTS]


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.1 * rng.randn(*np.shape(p)).astype(np.float32),
                        params)


def _parity(jmod, tmod, seed):
    x = np.random.RandomState(seed).randn(N, H, W, 3).astype(np.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    params = _perturbed(params, seed)
    want = jax.jit(lambda p, y: jmod.apply({"params": p}, y))(params, jnp.asarray(x))
    load_state_dict_strict(tmod, state_dict_from_flax(params))
    with torch.no_grad():
        got = tmod.eval()(torch.as_tensor(x))
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    for name in got:
        _close(got[name].numpy(), want[name])
    return got


@pytest.mark.parametrize("window", [7, 3])
def test_swin_matches_jax(window):
    """Window 7 pads every stage (16x19 -> 21x21 ... 2x3 -> 7x7); window 3
    shifts by 1 with padding at every stage (16x19 -> 18x21, 8x10 ->
    9x12, 4x5 -> 6x6, 2x3 -> 3x3)."""
    jmod = jswin.SwinTransformer(window=window, **SWIN_TINY)
    tmod = swin.SwinTransformer(window=window, **SWIN_TINY)
    got = _parity(jmod, tmod, seed=window)
    assert tuple(got["res2"].shape) == (N, 16, 19, 16)
    assert tuple(got["res5"].shape) == (N, 2, 3, 128)


@pytest.mark.parametrize("linear", [True, False])
def test_pvt_matches_jax(linear):
    """Stage maps 16x19, 8x10, 4x5, 2x3: the linear SRA pools each to 7x7
    by the AdaptiveAvgPool law (overlapping segments on the small maps),
    the strided SRA pads as flax's "SAME" (16x19 by 8 -> 2x3)."""
    jmod = jpvt.PVTv2(linear=linear, **PVT_TINY)
    tmod = pvt.PVTv2(linear=linear, **PVT_TINY)
    got = _parity(jmod, tmod, seed=11 + linear)
    assert tuple(got["res2"].shape) == (N, 16, 19, 16)
    assert tuple(got["res5"].shape) == (N, 2, 3, 64)


@pytest.mark.parametrize("w,shift,hp,wp", [(7, 3, 21, 28), (3, 1, 9, 12), (12, 6, 168, 240),
                                           (12, 6, 24, 36), (4, 2, 4, 8)])
def test_shift_mask_and_rel_index_equal_jax(w, shift, hp, wp):
    assert np.array_equal(swin._shift_mask(hp, wp, w, shift), jswin._shift_mask(hp, wp, w, shift))
    assert np.array_equal(swin._rel_pos_index(w), jswin._rel_pos_index(w))


def test_adaptive_pool_law_matches_jax():
    x = np.random.RandomState(3).randn(2, 9, 13, 4).astype(np.float32)
    want = np.asarray(jpvt.adaptive_avg_pool2d(jnp.asarray(x), 7))
    got = torch.nn.functional.adaptive_avg_pool2d(torch.as_tensor(x).permute(0, 3, 1, 2), 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


def _channels(name):
    if name.startswith("resnet"):
        return (256, 512, 1024, 2048)
    if name.startswith("swin"):
        return tuple(swin.VARIANTS[name]["embed_dim"] * 2 ** s for s in range(4))
    return pvt.VARIANTS[name]["dims"]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_factory_builds_every_variant_with_its_channels(name):
    """The pixel decoder takes the channels of the backbone built (embed x
    1, 2, 4, 8 for Swin, ``dims`` for PVT), in the model and in the
    standalone builder."""
    cfg = UniVSConfig(backbone=BackboneConfig(name=name))
    want = dict(zip(("res2", "res3", "res4", "res5"), _channels(name)))
    with torch.device("meta"):
        bb = build_backbone(cfg.backbone)
        model = univs_models.UniVSModel(cfg)
    assert bb.out_channels == want
    standalone = univs_models.build_pixel_decoder(cfg, device="cpu")
    for pd in (model.pixel_decoder, standalone):
        for i, level in enumerate(pd.names_td):
            assert getattr(pd, f"input_proj_{i}").in_channels == want[level]
        assert pd.adapter_0.in_channels == want["res2"]


@pytest.mark.parametrize("name", ["vit_base", "swin_huge", "pvt_v2_b4", "convnext_tiny"])
def test_factory_rejects_other_names(name):
    cfg = UniVSConfig(backbone=BackboneConfig(name=name))
    with pytest.raises(ValueError, match="unknown backbone"):
        build_backbone(cfg.backbone)
    with pytest.raises(ValueError, match="unknown backbone"):
        univs_models.build_pixel_decoder(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown backbone"):
        univs_models.build_model(cfg, device="cpu")


def _float32_held(module):
    return {f"{prefix}.{n}" if prefix else n
            for prefix, mod in module.named_modules()
            for n in getattr(mod, "keep_float32", ())}


@pytest.mark.parametrize("name", ["swin_tiny", "pvt_v2_b0"])
def test_bf16_build_keeps_float32_params(name):
    """The LayerNorms and Swin's bias tables stay float32 (the JAX package
    holds and applies them in float32); every other float tensor is
    bf16."""
    cfg = torch_tiny_config()
    cfg = cfg.replace(backbone=BackboneConfig(name=name), dtype="bfloat16")
    model = univs_models.build_model(cfg, device="cpu")
    held = _float32_held(model)
    n_ln = sum(isinstance(m, torch.nn.LayerNorm) and hasattr(m, "keep_float32")
               for m in model.backbone.modules())
    assert n_ln > 0 and len(held) >= 2 * n_ln
    if name.startswith("swin"):
        assert "backbone.stage0_block0.attn.relative_position_bias_table" in held
    for key, t in model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == (torch.float32 if key in held else torch.bfloat16), key
    x = torch.rand(1, 64, 96, 3) * 255
    with torch.no_grad():
        feats = model.backbone(model.normalize(x))
    assert all(f.dtype == torch.bfloat16 and bool(torch.isfinite(f).all()) for f in feats.values())


def test_bf16_vl_decoder_keeps_gammas_float32():
    cfg = torch_tiny_config().replace(dtype="bfloat16")
    c = cfg.pixel_decoder
    pd = MSDeformAttnPixelDecoderVL(dict(zip(("res2", "res3", "res4", "res5"), _channels("resnet50"))),
                                    hidden_dim=c.hidden_dim,
                                    mask_dim=c.mask_dim, num_layers=c.num_layers,
                                    num_heads=c.num_heads, num_points=c.num_points,
                                    ffn_dim=c.ffn_dim, lang_dim=16)
    pd = univs_models._place(pd, cfg, "cpu")
    held = _float32_held(pd)
    assert {"vl_fuse_0.gamma_v", "vl_fuse_0.gamma_l", "vl_fuse_0.layer_norm_v.weight"} <= held
    for key, t in pd.state_dict().items():
        assert t.dtype == (torch.float32 if key in held else torch.bfloat16), key


@pytest.mark.parametrize("name", ALL_NAMES)
def test_every_backbone_feeds_the_kernels_d32(name):
    """Every backbone feeds the same encoder: C=256, 8 heads, so D=32 —
    a head of 64 bytes in bf16 (kernel A reads 1, 2, 4 or 8 16-byte
    pieces a head) and token rows of 512 bytes (kernel C's wgmma body
    needs 16-byte alignment)."""
    cfg = UniVSConfig(backbone=BackboneConfig(name=name))
    with torch.device("meta"):
        pd = univs_models._pixel_decoder(cfg, build_backbone(cfg.backbone).out_channels)
    layers = [m for m in pd.modules() if isinstance(m, MSDeformAttnLayer)]
    assert len(layers) == cfg.pixel_decoder.num_layers == 6
    for m in layers:
        C = m.value_proj.out_features
        D = C // m.n_heads
        assert (C, m.n_heads, D) == (256, 8, 32)
        assert D * torch.bfloat16.itemsize in (16, 32, 64, 128)
        assert (C * torch.bfloat16.itemsize) % 16 == 0
