"""Parity of the port's vision-language pixel decoder against the JAX
package's on the CPU, in float32, with the flax weights (perturbed away
from their init, so the LayerNorms and gammas matter) bridged by
``state_dict_from_flax`` + ``load_state_dict_strict``: ``VLFuse`` (both
outputs) and ``MSDeformAttnPixelDecoderVL`` (all five outputs), with
language features padded (``lang_valid`` False on the last tokens) and
large logits that reach the +-50,000 clamps; within 1e-4 of each
output's largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.models import pixel_decoder_vl as jvl
from univs_tpu_torch.models import pixel_decoder_vl as tvl
from univs_tpu_torch.utils.weights import init_params, load_state_dict_strict, state_dict_from_flax

torch.set_num_threads(1)

CH = {"res2": 24, "res3": 40, "res4": 48, "res5": 64}
GEO = dict(hidden_dim=32, mask_dim=32, num_layers=2, num_heads=4, num_points=2, ffn_dim=64)
LANG, SL = 16, 7


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


def _lang(rng, b):
    lang = rng.randn(b, SL, LANG).astype(np.float32)
    valid = np.ones((b, SL), bool)
    valid[:, -2:] = False
    return lang, valid


@pytest.mark.parametrize("scale", [1.0, 3000.0])
def test_vlfuse_matches_jax(scale):
    """scale 3000 puts the bi-attention logits past the +-50,000 clamp."""
    rng = np.random.RandomState(int(scale))
    v = rng.randn(2, 30, 32).astype(np.float32)
    lang, valid = _lang(rng, 2)
    jm = jvl.VLFuse(v_dim=32, l_dim=LANG, embed_dim=64, num_heads=4)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), v, lang, valid)["params"], 1)
    params["attn"]["v_proj"]["kernel"] = params["attn"]["v_proj"]["kernel"] * scale
    want = jm.apply({"params": params}, v, lang, valid)
    tm = tvl.VLFuse(v_dim=32, l_dim=LANG, embed_dim=64, num_heads=4)
    load_state_dict_strict(tm, state_dict_from_flax(params))
    with torch.no_grad():
        got = tm(torch.as_tensor(v), torch.as_tensor(lang), torch.as_tensor(valid))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    if scale > 1:  # the clamp is reached: the law held past it
        with torch.no_grad():
            a = tm.attn
            q = a.v_proj(tm.layer_norm_v(torch.as_tensor(v)))
            k = a.l_proj(tm.layer_norm_l(torch.as_tensor(lang)))
        assert float((q @ k.transpose(-1, -2)).abs().max()) / 4 ** 0.5 > 50000


def test_vl_pixel_decoder_matches_jax():
    rng = np.random.RandomState(5)
    n = 2
    feats = {k: rng.randn(n, 64 // s, 96 // s, c).astype(np.float32)
             for (k, c), s in zip(CH.items(), (4, 8, 16, 32))}
    lang, valid = _lang(rng, 1)
    jm = jvl.MSDeformAttnPixelDecoderVL(lang_dim=LANG, **GEO)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats, lang, valid)["params"]
    params = _perturbed(params, 2)
    want = jax.jit(lambda p, f, l, v: jm.apply({"params": p}, f, l, v))(params, feats, lang, valid)
    tm = tvl.MSDeformAttnPixelDecoderVL(CH, lang_dim=LANG, **GEO)
    load_state_dict_strict(tm, state_dict_from_flax(params))
    with torch.no_grad():
        got = tm.eval()({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(lang),
                        torch.as_tensor(valid))
    assert len(got) == len(want) == 5
    mf, mf_bfe, enc, ms, lang_out = got
    _close(mf.numpy(), want[0])
    _close(mf_bfe.numpy(), want[1])
    _close(enc.numpy(), want[2])
    assert len(ms) == len(want[3]) == 3
    for g, w in zip(ms, want[3]):
        _close(g.numpy(), w)
    assert tuple(lang_out.shape) == (n, SL, LANG)
    _close(lang_out.numpy(), want[4])


def test_vl_decoder_seeded_init():
    """The port's init: gammas 1/6, level embeds N(0, 1), the sampling
    offsets' direction grid."""
    tm = tvl.MSDeformAttnPixelDecoderVL(CH, lang_dim=LANG, **GEO)
    init_params(tm, seed=0)
    assert bool((tm.vl_fuse_0.gamma_v == 1 / 6).all()) and bool((tm.vl_fuse_1.gamma_l == 1 / 6).all())
    assert float(tm.level_embed.detach().std()) > 0.5
    assert float(tm.encoder_layer_0.self_attn.sampling_offsets.bias.detach().abs().max()) > 0
