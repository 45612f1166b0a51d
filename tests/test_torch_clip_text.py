"""The CLIP text path of the PyTorch port against the JAX package on the
CPU: the tokenizer (no vocabulary in the repository, so its hash
fallback, whose ids agree inside one process), the text tower at a
small width (word and EOT features, causality), its weights carried
across by the bridge and its seeded init, ``TextPromptEncoder`` and
``PrepareTargets``.  Features to 1e-5."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.models.clip_text import ClipTextEncoder as JaxClipTextEncoder
from univs_tpu.models.clip_text import TextPromptEncoder as JaxTextPromptEncoder
from univs_tpu.models.tokenizer import ClipTokenizer as JaxClipTokenizer
from univs_tpu.models.tokenizer import clean_category_string as jax_clean
from univs_tpu.models.tokenizer import pre_tokenize as jax_pre_tokenize
from univs_tpu.prompts.prepare_targets import PrepareTargets as JaxPrepareTargets
from univs_tpu_torch.models import tokenizer as ttok
from univs_tpu_torch.models.clip_text import ClipTextEncoder, TextPromptEncoder
from univs_tpu_torch.prompts.prepare_targets import PrepareTargets
from univs_tpu_torch.utils import weights

torch.set_num_threads(1)

EXPRESSIONS = ["a man in a red shirt riding a bike", "the dog on the left",
               "Second car from the right, parked!"]
CLASS_NAMES = ["person", "traffic_light/signal", "tench, Tinca tinca,", "bear+cub"]
SMALL = dict(embed_dim=16, width=32, heads=4, num_layers=2)


@pytest.fixture(scope="module")
def small_tower():
    """A flax tower at width 32 on the full vocabulary (the tokenizer's
    ids reach 49,407) and the port's tower from the same weights."""
    enc = JaxClipTextEncoder(**SMALL)
    variables = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    variables = jax.tree.map(np.asarray, variables)
    tenc = ClipTextEncoder(**SMALL)
    weights.load_state_dict_strict(tenc, weights.state_dict_from_flax(variables["params"]))
    return enc, variables, tenc


@pytest.mark.parametrize("text_type,texts", [("expression", EXPRESSIONS),
                                             ("class_name", CLASS_NAMES)])
def test_tokenizer_ids_match_jax(text_type, texts):
    jt, tt = JaxClipTokenizer(), ttok.ClipTokenizer()
    assert not tt.has_vocab and jt.has_vocab == tt.has_vocab
    assert (tt.sot, tt.eot) == (jt.sot, jt.eot)
    got = ttok.pre_tokenize(texts, tt, text_type=text_type)
    want = jax_pre_tokenize(texts, jt, text_type=text_type)
    assert got.shape == (len(texts), 81, 77)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt(texts), jt(texts))
    assert [ttok.clean_category_string(t) for t in texts] == [jax_clean(t) for t in texts]


def test_tokenizer_builds_without_regex(monkeypatch, tmp_path):
    """No vocabulary: the fallback needs no ``regex``.  A vocabulary
    without ``regex`` is refused with a clear error."""
    monkeypatch.setitem(sys.modules, "regex", None)
    monkeypatch.delenv(ttok.VOCAB_ENV, raising=False)
    tok = ttok.ClipTokenizer()
    ids = tok(EXPRESSIONS)
    assert ids.shape == (3, 77) and (ids[:, 0] == tok.sot).all()
    vocab = tmp_path / "bpe.txt.gz"
    vocab.write_bytes(b"")
    with pytest.raises(ImportError, match="regex"):
        ttok.ClipTokenizer(str(vocab))
    monkeypatch.setenv(ttok.VOCAB_ENV, str(vocab))
    with pytest.raises(ImportError, match="regex"):
        ttok.ClipTokenizer()


def test_text_encoder_matches_jax(small_tower):
    enc, variables, tenc = small_tower
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 49406, (5, 77))
    tokens[:, 0] = 49406
    for n, end in enumerate((5, 9, 20, 76, 40)):
        tokens[n, end] = 49407
        tokens[n, end + 1:] = 0
    w_want, e_want = enc.apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        w_got, e_got = tenc(torch.as_tensor(tokens))
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_want), rtol=1e-5, atol=1e-5)


def test_text_encoder_causality():
    """tests/test_clip_text.py's geometry (vocab 100): a token changes no
    feature before it."""
    enc = JaxClipTextEncoder(embed_dim=32, width=32, heads=4, num_layers=2, vocab_size=100)
    t1 = np.array([[99, 5, 3, 2, 98, 0]])
    t2 = t1.copy()
    t2[0, 5] = 7
    variables = jax.tree.map(np.asarray, enc.init(jax.random.PRNGKey(1), jnp.asarray(t1)))
    tenc = ClipTextEncoder(embed_dim=32, width=32, heads=4, num_layers=2, vocab_size=100)
    weights.load_state_dict_strict(tenc, weights.state_dict_from_flax(variables["params"]))
    with torch.no_grad():
        w1, e1 = tenc(torch.as_tensor(t1))
        w2, _ = tenc(torch.as_tensor(t2))
    np.testing.assert_allclose(w1.numpy(), np.asarray(enc.apply(variables, jnp.asarray(t1))[0]),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w1[0, :5], w2[0, :5], rtol=0, atol=0)
    assert not torch.allclose(w1[0, 5], w2[0, 5])
    torch.testing.assert_close(e1[0], w1[0, 0], rtol=0, atol=0)  # EOT at the largest id (99)


def test_bridge_loads_the_flax_tower_strictly(small_tower):
    _, variables, tenc = small_tower
    state = weights.state_dict_from_flax(variables["params"])
    assert set(state) == set(tenc.state_dict())
    assert {"token_embedding", "positional_embedding", "text_projection",
            "block_1.attn.out_proj.weight", "block_0.c_fc.weight", "ln_final.weight"} <= set(state)
    np.testing.assert_array_equal(state["text_projection"],
                                  variables["params"]["text_projection"])  # [width, embed], as is
    np.testing.assert_array_equal(state["block_0.c_fc.weight"],
                                  variables["params"]["block_0"]["c_fc"]["kernel"].T)
    extra = dict(state, **{"block_2.ln_1.weight": np.ones(32, np.float32)})
    with pytest.raises(KeyError, match="block_2"):
        weights.load_state_dict_strict(ClipTextEncoder(**SMALL), extra)


def test_seeded_init_follows_jax_initializers():
    tenc = ClipTextEncoder(embed_dim=64, width=64, heads=4, num_layers=1)
    weights.init_params(tenc, seed=0)
    for p, std in ((tenc.token_embedding, 0.02), (tenc.positional_embedding, 0.01),
                   (tenc.text_projection, 64 ** -0.5)):
        p = p.detach()
        assert abs(float(p.std()) / std - 1.0) < 0.05 and abs(float(p.mean())) < 0.1 * std
    again = ClipTextEncoder(embed_dim=64, width=64, heads=4, num_layers=1)
    weights.init_params(again, seed=0)
    for (k, a), b in zip(tenc.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_text_prompt_encoder_and_prepare_targets_match_jax(small_tower):
    enc, variables, tenc = small_tower
    jpe = JaxTextPromptEncoder(variables, enc, JaxClipTokenizer())
    tpe = TextPromptEncoder(weights.state_dict_from_flax(variables["params"]),
                            ClipTextEncoder(**SMALL), ttok.ClipTokenizer(), device="cpu")
    assert next(tpe.encoder.parameters()).dtype == torch.float32

    w_want, s_want = jpe.encode_expressions(EXPRESSIONS)
    w_got, s_got = tpe.encode_expressions(EXPRESSIONS)
    assert tuple(w_got.shape) == (3, 77, 16) and tuple(s_got.shape) == (3, 16)
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpe.encode_category_names(CLASS_NAMES).numpy(),
                               np.asarray(jpe.encode_category_names(CLASS_NAMES)),
                               rtol=1e-5, atol=1e-5)

    bank = np.random.RandomState(1).randn(3938, 16).astype(np.float32)
    jprep, tprep = JaxPrepareTargets(bank, jpe), PrepareTargets(bank, tpe)
    np.testing.assert_array_equal(tprep.category_slice("ytvis_2021_val"),
                                  jprep.category_slice("ytvis_2021_val"))
    jtp, jsl = jprep.detection_inputs("vipseg_val")
    ttp, tsl = tprep.detection_inputs("vipseg_val")
    np.testing.assert_array_equal(ttp.embs.numpy(), np.asarray(jtp.embs))
    np.testing.assert_array_equal(ttp.valid.numpy(), np.asarray(jtp.valid))
    for pad_to in (None, 5):
        want = jprep.grounding_inputs(EXPRESSIONS[:2], pad_to=pad_to)
        got = tprep.grounding_inputs(EXPRESSIONS[:2], pad_to=pad_to)
        assert tuple(got.embs.shape) == tuple(want.embs.shape) == (1, pad_to or 2, 78, 16)
        np.testing.assert_allclose(got.embs.numpy(), np.asarray(want.embs), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_text_prompt_encoder_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextPromptEncoder(encoder=ClipTextEncoder(**SMALL))


def test_text_prompt_encoder_seeds_the_tower_it_is_given():
    """A tower passed as ``encoder`` gets the seeded init (its own
    parameters start at zero, which would make every feature 0); a
    module passed as ``params`` is refused rather than used as is."""
    with pytest.raises(TypeError, match="encoder="):
        TextPromptEncoder(ClipTextEncoder(**SMALL), device="cpu")
    feats = {}
    for seed in (5, 6):
        tpe = TextPromptEncoder(encoder=ClipTextEncoder(**SMALL), device="cpu", seed=seed)
        feats[seed] = tpe.encode_expressions(EXPRESSIONS)
    word, sent = feats[5]
    assert bool(word.abs().amax(dim=(1, 2)).gt(0).all()) and bool(sent.abs().amax(1).gt(0).all())
    for a in range(len(EXPRESSIONS)):
        for b in range(a):
            assert not torch.allclose(sent[a], sent[b])
    assert not torch.allclose(sent, feats[6][1])
