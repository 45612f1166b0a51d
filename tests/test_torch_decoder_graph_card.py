"""On the card (``python3 -m pytest --noconftest
tests/test_torch_decoder_graph_card.py -m card``: the card's machine has
no JAX, which ``tests/conftest.py`` sets up; skips without a card): the
decoder's layer stack replayed from a CUDA graph, at the decodes of the
benchmark's two inference cells with the port's seeded weights in bf16:
vis-r50's sot decode (univs-r50, 640x960, T = 5, 200 + 60 queries, K =
40, the pool's prompt kv) and vss-swinl's detection decode (univs-swinl,
K = 124, no prompts).  A key's first call and every grad-enabled or
training call run eagerly and capture nothing; the second call captures
once and replays; a replay equals the eager forward bit for bit, and the
outputs a call returned survive the next replay on other inputs.  No JAX
is imported here."""

import dataclasses
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from univs_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T = 640, 960, 5
OUTS = ("pred_logits", "pred_masks", "pred_embds")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _config(name):
    from benchmark.harness.configs import program_config

    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return program_config(json.load(f)["model"])


def _decoder(cfg, dev, seed=0):
    """The port's seeded decoder weights, drawn in float32 and cast to the
    configuration's dtype by ``build_decoder``, on the card."""
    from univs_tpu_torch.models.univs import build_decoder
    from univs_tpu_torch.utils.weights import init_params

    seeded = build_decoder(cfg.replace(dtype="float32"), device="cpu")
    with torch.no_grad():
        init_params(seeded, seed)
    dec = build_decoder(cfg, device=dev)
    dec.load_state_dict(seeded.state_dict())
    return dec


def _features(cfg, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    C, dt = cfg.decoder.hidden_dim, torch.bfloat16
    ms = [torch.randn((T, H // s, W // s, C), generator=g, device=dev).to(dt) for s in (32, 16, 8)]
    mf = torch.randn((T, H // 4, W // 4, cfg.decoder.mask_dim), generator=g, device=dev).to(dt)
    return ms, mf


def _bank(cfg, dev, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((k, cfg.decoder.clip_cls_emb_dim), generator=g, device=dev)


def _pool_prompts(cfg, dev, seed):
    """The clip step's visual prompts (``entity_clip_step``) from a pool of
    vis-r50's size whose prompt entries are drawn, half its slots valid."""
    from univs_tpu_torch.inference import memory_pool as mp
    from univs_tpu_torch.structures import VisualPrompts

    pool = mp.create_entity_memory(60, 40, cfg.decoder.hidden_dim, (H // 4, W // 4), window=T,
                                   num_prompt_points=cfg.prompt.num_dense_points_test,
                                   embd_history=8, prompt_history=T + 1, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for name in ("prompt_feats", "prompt_pe", "first_feats", "first_pe"):
        x = getattr(pool, name)
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
    for name in ("prompt_valid", "first_valid"):
        x = getattr(pool, name)
        x.copy_(torch.rand(x.shape, generator=g, device=dev) > 0.3)
    pool.valid.copy_(torch.arange(60, device=dev) % 2 == 0)
    kv, kv_pe, kv_valid = mp.read_prompt_kv(pool, cfg.prompt.num_prev_frames_memory)
    queries, query_pos = mp.read_clip_queries(pool, T)
    return VisualPrompts(queries=queries[None], query_pos=query_pos[None],
                         kv=kv[None, :, :, None], kv_pe=kv_pe[None, :, :, None],
                         kv_valid=kv_valid[None, :, :, None], valid=pool.valid[None])


def _cell(name, dev):
    """(decoder, inputs(seed) -> call kwargs) of one cell's decode."""
    if name == "vis-r50":
        cfg = _config("univs-r50")

        def inputs(seed):
            ms, mf = _features(cfg, dev, seed)
            return dict(x_levels=ms, mask_features=mf, task="sot",
                        visual_prompts=_pool_prompts(cfg, dev, seed + 1),
                        cls_emb=_bank(cfg, dev, 40, seed + 2))
    else:
        cfg = _config("univs-swinl")

        def inputs(seed):
            ms, mf = _features(cfg, dev, seed)
            return dict(x_levels=ms, mask_features=mf, task="detection",
                        cls_emb=_bank(cfg, dev, 124, seed + 2))
    return _decoder(cfg, dev), inputs


def _run(dec, kw, frames=range(3, 3 + T), **extra):
    fi = torch.as_tensor(list(frames), device=kw["mask_features"].device)[None]
    return dec(kw["x_levels"], kw["mask_features"], fi, task=kw["task"],
               visual_prompts=kw.get("visual_prompts"), cls_emb=kw["cls_emb"], **extra)


def _counted(fn):
    """(fn's result, the change of the decoder's graph counters under a
    session)."""
    names = ("decoder_graph_captures", "decoder_graph_replays")
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    torch.cuda.synchronize()
    after = profiling.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in names}


def _copy(out):
    return {k: out[k].clone() for k in OUTS}


def _equal(got, want):
    for k in OUTS:
        assert torch.equal(got[k], want[k]), (k, float((got[k].float() - want[k].float())
                                                     .abs().max()))


@pytest.mark.card
@pytest.mark.parametrize("cell", ["vis-r50", "vss-swinl"])
def test_replay_equals_eager_and_outputs_stay_the_callers(card, cell):
    dec, inputs = _cell(cell, card)
    a, b = inputs(10), inputs(20)
    with torch.no_grad():
        first, n = _counted(lambda: _run(dec, a))
        assert n == {"decoder_graph_captures": 0, "decoder_graph_replays": 0}, n
        assert not dec._graphs.graphs
        eager_a = _copy(first)
        with torch.enable_grad():  # grad on: eager, no capture
            eager_b = _copy(_run(dec, b))
        replay_a, n = _counted(lambda: _run(dec, a))
        assert n == {"decoder_graph_captures": 1, "decoder_graph_replays": 1}, n
        _equal(replay_a, eager_a)
        replay_b, n = _counted(lambda: _run(dec, b))
        assert n == {"decoder_graph_captures": 0, "decoder_graph_replays": 1}, n
        _equal(replay_b, eager_b)
        _equal(replay_a, eager_a)  # the earlier call's outputs survive the replay
        _equal(first, eager_a)
        if cell == "vis-r50":
            assert replay_b["prompt_valid"] is b["visual_prompts"].valid
        (_, n) = _counted(lambda: [_run(dec, b) for _ in range(3)])
        assert n == {"decoder_graph_captures": 0, "decoder_graph_replays": 3}, n
        assert len(dec._graphs.graphs) == 1


@pytest.mark.card
def test_grad_training_and_first_sightings_capture_nothing(card):
    dec, inputs = _cell("vis-r50", card)
    a = inputs(30)
    perms = [torch.arange(T, device=card)] * (dec.num_layers + 1)
    _, n = _counted(lambda: [_run(dec, a) for _ in range(2)])  # grad on: eager
    assert n == {"decoder_graph_captures": 0, "decoder_graph_replays": 0}, n
    with torch.no_grad():
        _, n = _counted(lambda: [_run(dec, a, train=True, shuffle_perms=perms)
                                 for _ in range(2)])
        assert n == {"decoder_graph_captures": 0, "decoder_graph_replays": 0}, n
        # another key (T = 3) seen once, then the first key's first sighting
        vp = a["visual_prompts"]
        short = dict(a, x_levels=[m[:3] for m in a["x_levels"]],
                     mask_features=a["mask_features"][:3],
                     visual_prompts=dataclasses.replace(vp, queries=vp.queries[:, :, :3],
                                                        query_pos=vp.query_pos[:, :, :3]))
        _, n = _counted(lambda: [_run(dec, short, frames=range(3)), _run(dec, a)])
        assert n == {"decoder_graph_captures": 0, "decoder_graph_replays": 0}, n
        _, n = _counted(lambda: [_run(dec, short, frames=range(3)), _run(dec, a),
                                 _run(dec, a)])
        assert n == {"decoder_graph_captures": 2, "decoder_graph_replays": 3}, n
    assert len(dec._graphs.graphs) == 2
