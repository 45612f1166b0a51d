"""Stage-3 long-video training in the port against the JAX package:
``clip_starts`` over a grid of (Tv, T); the inter-clip ReID law of one
layer on seeded arrays; and ``long_video_loss`` (Tv=4 in clips of T=2,
so three clips, two encodes each) on the tiny training config, its
logged terms and total within 1e-4 and its gradient on named parameters
of every part of the model (backbone, pixel decoder, decoder heads)
within 1e-4 of each gradient's scale, the draws replayed from the JAX
key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_util import jax_key, seeded_flax_params, train_cfgs
from univs_tpu.losses.criterion import TrainTargets as JTargets
from univs_tpu.losses.criterion import UniCriterion as JCriterion
from univs_tpu.models.univs import UniVSModel as JaxModel
from univs_tpu.parallel import long_video as jlv
from univs_tpu.structures import TextPrompts as JaxTextPrompts
from univs_tpu_torch.losses.criterion import TrainTargets as TTargets
from univs_tpu_torch.losses.criterion import UniCriterion as TCriterion
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.parallel import long_video as tlv
from univs_tpu_torch.parallel.train_state import create_train_state
from univs_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)


def test_clip_starts_match_jax():
    for tv in range(1, 13):
        for t in range(1, 7):
            assert tlv.clip_starts(tv, t) == jlv.clip_starts(tv, t), (tv, t)
    assert tlv.clip_starts(7, 3) == [0, 2, 4]


@pytest.mark.parametrize("seed", [0, 1])
def test_interclip_layer_loss_matches_jax(seed):
    """Two videos, slots absent on some frames, an invalid slot, a slot
    absent on every frame; the anchors' Gumbel draws replayed."""
    torch.set_num_threads(1)
    rng = np.random.RandomState(seed)
    B, N, Tall, C = 2, 4, 6, 8
    emb = rng.randn(B, N, Tall, C).astype(np.float32)
    ids = np.broadcast_to(np.arange(N)[None, :, None], (B, N, Tall)).astype(np.int32).copy()
    ids[rng.rand(B, N, Tall) < 0.3] = -1
    ids[1, 2] = -1
    valid = np.ones((B, N), bool)
    valid[0, 3] = False
    jkey, tkey = jax_key(20 + seed)
    jc, ja = jlv._interclip_layer_loss(jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(valid), jkey)
    tc, ta = tlv._interclip_layer_loss(torch.as_tensor(emb), torch.as_tensor(ids).long(),
                                       torch.as_tensor(valid), tkey)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)


# named parameters whose gradients are compared: one of each part the loss
# reaches (backbone trunk and stem, the encoder's projections and FFN, the
# FPN, the decoder's queries, attention, FFN, prompt embedding and mask
# head; the class head takes no gradient here, sot's one all-zero class)
GRAD_KEYS = (
    "backbone.stem_conv.weight", "backbone.res4_block0.conv2.weight",
    "pixel_decoder.encoder_layer_0.self_attn.sampling_offsets.weight",
    "pixel_decoder.encoder_layer_0.linear2.weight", "pixel_decoder.mask_features.weight",
    "decoder.query_feat", "decoder.cross_0.attn.out_proj.weight", "decoder.prompt_sot",
    "decoder.proca_0.attn.q_proj.weight", "decoder.mask_embed.layer2.weight",
    "decoder.ffn_0.linear1.weight",
)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    jcfg, tcfg = train_cfgs()
    B, Tv, H, W = 1, 4, 64, 96
    N = jcfg.prompt.num_max_instances
    rng = np.random.RandomState(0)
    images = (rng.rand(B, Tv, H, W, 3) * 255).astype(np.float32)
    fi = np.broadcast_to(np.arange(Tv)[None], (B, Tv)).astype(np.int32)
    masks = (rng.rand(B, N, Tv, H // 4, W // 4) > 0.8).astype(np.float32)
    ids = np.broadcast_to(np.arange(N)[None, :, None], (B, N, Tv)).astype(np.int32).copy()
    ids[0, 1, 2] = -1  # absent on one frame of the second clip
    masks[0, 1, 2] = 0.0
    valid = np.array([[True, True, True, False]])
    labels = np.ones((B, N), np.int32)
    model = JaxModel(jcfg)
    K = 5
    bank = jnp.asarray(rng.randn(K, jcfg.decoder.clip_cls_emb_dim).astype(np.float32))
    tp = JaxTextPrompts(embs=bank[None, :, None, :], valid=jnp.ones((B, K), bool))
    params = seeded_flax_params(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        jnp.asarray(images[:, :2]), jnp.asarray(fi[:, :2]), task="detection", text_prompts=tp,
        cls_emb=bank, train=True)["params"], seed=1)
    jkey, tkey = jax_key(2)

    jt = JTargets(labels=jnp.asarray(labels), ids=jnp.asarray(ids), masks=jnp.asarray(masks),
                  valid=jnp.asarray(valid), prompt_obj_ids=jnp.zeros((B, N), jnp.int32))
    jcrit = JCriterion(jcfg.train, jcfg.decoder.num_queries, jcfg.num_frames)

    @jax.jit
    def loss_and_grad(p):
        return jax.value_and_grad(lambda q: jlv.long_video_loss(
            model, q, jcrit, jnp.asarray(images), jnp.asarray(fi), jt, jcfg, jkey), has_aux=True)(p)

    (jtotal, jlog), jgrads = loss_and_grad(params)
    jgrads = state_dict_from_flax(jgrads)

    sd = state_dict_from_flax(params)
    tmodel = build_model(tcfg, sd, device="cpu")
    create_train_state(tcfg, tmodel, sd)  # trainable, as in a train step
    tt = TTargets(labels=torch.as_tensor(labels).long(), ids=torch.as_tensor(ids).long(),
                  masks=torch.as_tensor(masks), valid=torch.as_tensor(valid),
                  prompt_obj_ids=torch.zeros((B, N), dtype=torch.long))
    tcrit = TCriterion(tcfg.train, tcfg.decoder.num_queries, tcfg.num_frames)
    ttotal, tlog = tlv.long_video_loss(tmodel, tcrit, torch.as_tensor(images),
                                       torch.as_tensor(fi).long(), tt, tcfg, tkey)
    ttotal.backward()
    tgrads = {k: p.grad for k, p in tmodel.named_parameters()}
    return dict(jtotal=float(jtotal), jlog={k: float(v) for k, v in jlog.items()},
                ttotal=float(ttotal.detach()), tlog={k: float(v.detach()) for k, v in tlog.items()},
                jgrads=jgrads, tgrads=tgrads)


def test_long_video_loss_matches_jax(runs):
    r = runs
    assert set(r["tlog"]) == set(r["jlog"])
    assert {f"clip{c}_loss_reid" for c in range(3)} <= set(r["tlog"])
    assert "loss_reid_interclip" in r["tlog"] and "loss_reid_interclip_aux" in r["tlog"]
    for k, j in r["jlog"].items():
        assert abs(r["tlog"][k] - j) <= 1e-4 * max(1.0, abs(j)), (k, j, r["tlog"][k])
    assert np.isfinite(r["ttotal"])
    assert abs(r["ttotal"] - r["jtotal"]) <= 1e-4 * max(1.0, abs(r["jtotal"]))


@pytest.mark.parametrize("name", GRAD_KEYS)
def test_long_video_gradient_matches_jax(runs, name):
    j = np.asarray(runs["jgrads"][name], np.float32)
    g = runs["tgrads"][name]
    assert g is not None, name
    scale = float(np.abs(j).max())
    assert scale > 0, name
    err = float(np.abs(g.numpy() - j).max())
    assert err <= 1e-4 * scale, (name, err, scale)
