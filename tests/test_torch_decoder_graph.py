"""The decoder's layer stack off the card: the static self-attention bias
served from memory equals a fresh build for every mask type, task and
prompt count, and is built once per key; on the CPU the decoder never
captures a CUDA graph, and its outputs equal those of the benchmark's
frozen copy of the decoder as it was before the layer stack could replay
(``benchmark/reference/models/decoder.py``), bit for bit, in inference
and in training.  No JAX is imported here."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference.models.decoder import UniVSDecoder as FrozenDecoder
from benchmark.reference.structures import TextPrompts as FrozenText
from benchmark.reference.structures import VisualPrompts as FrozenVisual
from univs_tpu_torch.models import decoder as dec_mod
from univs_tpu_torch.models.decoder import UniVSDecoder, build_self_attn_bias, self_attn_bias
from univs_tpu_torch.structures import TextPrompts, VisualPrompts
from univs_tpu_torch.utils import profiling

torch.set_num_threads(1)

MASK_TYPES = ("sep", "sep-blocked", "sep-l2p", "none", "all")
TASKS = ("detection", "sot", "grounding")
DIMS = dict(hidden_dim=32, num_queries=6, num_layers=3, num_heads=4, ffn_dim=64, mask_dim=32,
            text_emb_dim=16, num_max_frames=16)
B, T, L, QP, QE, K = 1, 3, 4, 3, 2, 5
SIZES = ((2, 3), (4, 6), (8, 12))


@pytest.mark.parametrize("qp", [0, 60])
@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("mask_type", MASK_TYPES)
def test_cached_self_attn_bias_equals_a_fresh_build(mask_type, task, qp):
    dec_mod._device_bias.cache_clear()
    got = self_attn_bias(200, qp, 5, mask_type, task, "cpu")
    want = build_self_attn_bias(200, qp, 5, mask_type, task, device="cpu")
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert self_attn_bias(200, qp, 5, mask_type, task, torch.device("cpu")) is got
    assert dec_mod._device_bias.cache_info().currsize == 1


def test_bias_cache_keeps_the_most_recent_keys():
    dec_mod._device_bias.cache_clear()
    first = self_attn_bias(4, 1, 2, "sep", "sot", "cpu")
    for t in range(3, 3 + dec_mod.BIASES):
        self_attn_bias(4, 1, t, "sep", "sot", "cpu")
    assert dec_mod._device_bias.cache_info().currsize == dec_mod.BIASES
    assert self_attn_bias(4, 1, 2, "sep", "sot", "cpu") is not first


def _pair():
    """The decoder and its frozen copy, the same seeded weights."""
    g = torch.Generator().manual_seed(3)
    dec = UniVSDecoder(**DIMS)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    frozen = FrozenDecoder(**DIMS)
    frozen.load_state_dict(dec.state_dict())
    return dec.eval(), frozen.eval()


def _inputs(task, seed):
    g = torch.Generator().manual_seed(seed)
    C, Dt = DIMS["hidden_dim"], DIMS["text_emb_dim"]

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    levels = [rnd(B * T, h, w, C) for h, w in SIZES]
    mf = rnd(B * T, 16, 24, DIMS["mask_dim"])
    fi = torch.arange(2, 2 + T)[None]
    kw = {"cls_emb": rnd(K, Dt)}
    vp = tp = None
    if task == "sot":
        valid = torch.tensor([[True, False, True]])
        vp = (rnd(B, QP, T, C), rnd(B, QP, T, C), rnd(B, QP, L, 1, C), rnd(B, QP, L, 1, C),
              torch.rand((B, QP, L, 1), generator=g) > 0.3, valid)
    elif task == "grounding":
        kw = {}
        tp = (rnd(B, QE, 1 + L, Dt), torch.tensor([[True, False]]))
    return levels, mf, fi, kw, vp, tp


def _call(dec, visual, text, args, **kw):
    levels, mf, fi, base, vp, tp = args
    extra = dict(base)
    if vp is not None:
        extra["visual_prompts"] = visual(*vp)
    if tp is not None:
        extra["text_prompts"] = text(embs=tp[0], valid=tp[1])
    return dec(levels, mf, fi, **extra, **kw)


def _counted(fn):
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _same(got, want, keys=("pred_logits", "pred_masks", "pred_embds")):
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


@pytest.mark.parametrize("task", TASKS)
def test_cpu_decoder_never_captures_and_equals_the_frozen_copy(task):
    dec, frozen = _pair()
    with torch.no_grad():
        def three():
            return [_call(dec, VisualPrompts, TextPrompts, _inputs(task, s), task=task)
                    for s in (5, 5, 6)]

        outs, change = _counted(three)
        for s, got in zip((5, 5, 6), outs):
            want = _call(frozen, FrozenVisual, FrozenText, _inputs(task, s), task=task)
            _same(got, want)
            assert got["aux_outputs"] == []
            if task != "detection":
                assert torch.equal(got["prompt_valid"], want["prompt_valid"])
    assert not any(k.startswith("decoder_graph") for k in change), change
    assert change.get("decoder_graph_captures", 0) == 0
    assert not dec._graphs.graphs and not dec._graphs.seen


@pytest.mark.parametrize("task", ["detection", "sot"])
def test_cpu_training_forward_equals_the_frozen_copy(task):
    dec, frozen = _pair()
    args = _inputs(task, 7)
    perms = [torch.randperm(T, generator=torch.Generator().manual_seed(k))
             for k in range(DIMS["num_layers"] + 1)]
    got = _call(dec, VisualPrompts, TextPrompts, args, task=task, train=True,
                shuffle_perms=perms)
    want = _call(frozen, FrozenVisual, FrozenText, args, task=task, train=True,
                 shuffle_perms=perms)
    _same(got, want)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == DIMS["num_layers"]
    for a, b in zip(got["aux_outputs"], want["aux_outputs"]):
        _same(a, b)
    got["pred_masks"].float().sum().backward()
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in dec.parameters())
    assert not dec._graphs.graphs and not dec._graphs.seen


def test_graphs_are_not_copied_with_the_module():
    import copy
    import pickle

    dec, _ = _pair()
    dec._graphs.seen["key"] = None
    twin = copy.deepcopy(dec)
    assert twin._graphs is not dec._graphs and not twin._graphs.seen
    again = pickle.loads(pickle.dumps(dec))
    assert not again._graphs.seen and not again._graphs.graphs
    np.testing.assert_array_equal(again.query_feat.detach().numpy(),
                                  dec.query_feat.detach().numpy())


class _FakeGraph:
    """A stand-in for a captured stack on the CPU: it runs the stack on
    its own copies of the inputs at each replay, as a graph would."""

    made = []

    def __init__(self, fn, inputs, held):
        self.fn, self.inputs, self.held = fn, [x.clone() for x in inputs], held
        _FakeGraph.made.append(self)

    def replay(self, inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        return tuple(y.clone() for y in self.fn(*self.inputs))


def test_a_key_captures_at_its_second_call_and_the_oldest_graph_goes(monkeypatch):
    monkeypatch.setattr(dec_mod, "_StackGraph", _FakeGraph)
    _FakeGraph.made.clear()
    graphs = dec_mod._StackGraphs()
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2,)

    def run(key, v):
        return graphs.run(key, fn, (torch.full((2,), float(v)),), held=("bias",))

    def counted(f):
        return _counted(f)[1]

    change = counted(lambda: [run("a", 1)])
    assert not change and not _FakeGraph.made and list(graphs.seen) == ["a"]
    change = counted(lambda: [run("a", 2), run("a", 3)])
    assert change == {"decoder_graph_captures": 1, "decoder_graph_replays": 2}, change
    assert len(_FakeGraph.made) == 1 and _FakeGraph.made[0].held == ("bias",)
    assert torch.equal(run("a", 4)[0], torch.full((2,), 8.0)) and "a" not in graphs.seen
    for k in range(dec_mod.GRAPHS):
        run(k, 0)
        run(k, 0)
    assert list(graphs.graphs) == list(range(dec_mod.GRAPHS)), list(graphs.graphs)
    run("a", 5)  # evicted: seen once more before it captures again
    assert "a" in graphs.seen and "a" not in graphs.graphs
    for k in range(dec_mod.SEEN + 1):
        run(("once", k), 0)
    assert len(graphs.seen) == dec_mod.SEEN and "a" not in graphs.seen
