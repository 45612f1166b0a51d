"""Module parity of the PyTorch port against the JAX package on the CPU:
the R50 backbone (res2..res5), the pixel decoder (mask features and the
three multi-scale maps) and the decoder (tasks 'detection' and 'sot'),
on ``tiny_test_config`` with the same weights through the weight bridge.
Float32 throughout; tolerance 1e-4 relative to each output's largest
magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.config import tiny_test_config
from univs_tpu.models.univs import UniVSModel, build_decoder, build_pixel_decoder
from univs_tpu.structures import TextPrompts
from univs_tpu.structures import VisualPrompts as JaxVisualPrompts
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.structures import VisualPrompts
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)

T, H, W, K = 2, 64, 96, 5


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    jm = UniVSModel(cfg)
    rng = np.random.RandomState(0)
    images = rng.rand(1, T, H, W, 3).astype(np.float32) * 255
    cls_emb = rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
    tp = TextPrompts(embs=jnp.asarray(cls_emb)[None, :, None, :], valid=jnp.ones((1, K), bool))
    init = jax.jit(lambda r, im, fi: jm.init({"params": r}, im, fi, task="detection",
                                             text_prompts=tp, cls_emb=jnp.asarray(cls_emb)))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), images, jnp.arange(T)[None])["params"])
    tm = build_model(torch_tiny_config(), state_dict_from_flax(params), device="cpu")
    bb = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=lambda m, y: m.backbone(m.normalize(y))))(
        params, images.reshape(T, H, W, 3))
    mf, _, _, ms = jax.jit(lambda p, f: build_pixel_decoder(cfg).apply({"params": p}, f))(
        params["pixel_decoder"], bb)
    return dict(cfg=cfg, params=params, tm=tm, images=images, cls_emb=cls_emb,
                bb=jax.tree.map(np.array, bb), mf=np.array(mf), ms=[np.array(m) for m in ms])


def test_backbone_parity(models):
    tm = models["tm"]
    with torch.no_grad():
        got = tm.backbone(tm.normalize(torch.as_tensor(models["images"].reshape(T, H, W, 3))))
    for name in ("res2", "res3", "res4", "res5"):
        _close(got[name].numpy(), models["bb"][name])


def test_pixel_decoder_parity(models):
    feats = {k: torch.as_tensor(v) for k, v in models["bb"].items()}
    with torch.no_grad():
        mf, _, _, ms = models["tm"].pixel_decoder(feats)
    _close(mf.numpy(), models["mf"])
    assert len(ms) == 3
    for got, want in zip(ms, models["ms"]):
        _close(got.numpy(), want)


def _pool_like_prompts(rng, qp, l, c):
    """Pool-read-shaped visual prompts: singleton frame axis, blank
    (zero) entries, one invalid slot."""
    kv = rng.randn(1, qp, l, 1, c).astype(np.float32)
    kv_pe = rng.randn(1, qp, l, 1, c).astype(np.float32)
    kv_valid = rng.rand(1, qp, l, 1) > 0.3
    kv *= kv_valid[..., None]
    kv_pe *= kv_valid[..., None]
    valid = np.array([[True] * (qp - 1) + [False]])
    q = rng.randn(1, qp, T, c).astype(np.float32)
    qpos = rng.randn(1, qp, T, c).astype(np.float32)
    return q, qpos, kv, kv_pe, kv_valid, valid


@pytest.mark.parametrize("task", ["detection", "sot"])
def test_decoder_parity(models, task):
    cfg, params = models["cfg"], models["params"]
    fi = np.arange(3, 3 + T)[None]
    jvp = tvp = None
    if task == "sot":
        arrs = _pool_like_prompts(np.random.RandomState(1), 3, 6, cfg.decoder.hidden_dim)
        jvp = JaxVisualPrompts(*[jnp.asarray(a) for a in arrs])
        tvp = VisualPrompts(*[torch.as_tensor(a) for a in arrs])
    want = jax.jit(lambda p, ms, mf, fi, ce, vp: build_decoder(cfg).apply(
        {"params": p}, ms, mf, fi, task=task, visual_prompts=vp, cls_emb=ce))(
        params["decoder"], models["ms"], models["mf"], jnp.asarray(fi), models["cls_emb"], jvp)
    with torch.no_grad():
        got = models["tm"].decoder([torch.as_tensor(m) for m in models["ms"]],
                                   torch.as_tensor(models["mf"]), torch.as_tensor(fi), task=task,
                                   visual_prompts=tvp, cls_emb=torch.as_tensor(models["cls_emb"]))
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        _close(got[k].numpy(), want[k])


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_weight_bridge_rejects_unmapped_keys(models, fault):
    sd = state_dict_from_flax(models["params"])
    key = "pixel_decoder.encoder_layer_0.linear1.weight"
    if fault == "extra":
        sd["decoder.not_a_layer.weight"] = np.zeros(3, np.float32)
    elif fault == "missing":
        del sd[key]
    else:
        sd[key] = sd[key].T
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        build_model(torch_tiny_config(), sd, device="cpu")


def test_seeded_init_matches_deformable_detr_init(models):
    """The port's own init (no JAX): the sampling offsets get a zero
    kernel and the direction-grid bias, the attention weights zero, as
    the JAX package's init gives them."""
    tm = build_model(torch_tiny_config(), None, seed=5, device="cpu")
    jp = models["params"]["pixel_decoder"]
    for li in range(torch_tiny_config().pixel_decoder.num_layers):
        layer = getattr(tm.pixel_decoder, f"encoder_layer_{li}").self_attn
        jl = jp[f"encoder_layer_{li}"]["self_attn"]
        np.testing.assert_array_equal(layer.sampling_offsets.bias.numpy(),
                                      np.asarray(jl["sampling_offsets"]["bias"]))
        assert not layer.sampling_offsets.weight.any() and not layer.attention_weights.weight.any()
        assert not layer.attention_weights.bias.any()
    again = build_model(torch_tiny_config(), None, seed=5, device="cpu").state_dict()
    assert all(torch.equal(v, again[k]) for k, v in tm.state_dict().items())
