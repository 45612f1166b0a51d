"""Data parallelism in the port (``parallel/ddp.py``): two processes on
gloo over the CPU, each with one video of a B=2 batch (every video holds
targets, so the cross-video contrastive negatives, the column cap and
the global normalisers all matter), run two steps of the tiny detection,
sot and grounding train steps from the same weights and key; every
rank's logged losses equal the one-process step's on the whole batch
within 1e-5, and the float32 params and EMA after two steps within 1e-5
(the biases whose gradient is 0 in exact arithmetic move by rounding
noise only, less than one step).  Also: a rank's draws (the matcher's
keys, the PointRend rows, the sot prompt draws and PE coin) are its
slice of the global batch's, and ``shard_batch`` slices the videos and
replicates the class bank."""

import dataclasses
import socket

import pytest
import torch
import torch.multiprocessing as mp

from torch_train_util import tiny_train_arrays, torch_batch, train_cfgs, zero_gradient_in_law
from univs_tpu_torch.losses import criterion as tc
from univs_tpu_torch.models.univs import build_model, draw_train_prompts
from univs_tpu_torch.parallel import ddp
from univs_tpu_torch.parallel import train_state as tts
from univs_tpu_torch.utils.draws import make_key

torch.set_num_threads(1)

TASKS = ("detection", "sot", "grounding")
WORLD = 2
EMA_DECAY = 0.5


def _cfg():
    _, cfg = train_cfgs()
    return cfg.replace(train=dataclasses.replace(cfg.train, ema_decay=EMA_DECAY))


def _two_steps(cfg, task, batch, step_fn):
    model = build_model(cfg, None, seed=4, device="cpu")
    state = tts.create_train_state(cfg, model)
    step = step_fn(cfg, model, task)
    key = make_key(6, device="cpu")
    state, logged = step(state, batch, key)
    state, _ = step(state, batch, key)
    return ({k: float(v) for k, v in logged.items()},
            {k: v.clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.ema_params.items()})


def _worker(rank, port, out_path):
    torch.set_num_threads(1)
    ddp.init_distributed("gloo", f"tcp://127.0.0.1:{port}", rank, WORLD)
    try:
        cfg = _cfg()
        arrays = tiny_train_arrays(cfg)
        res = {"shard": dataclasses.astuple(ddp.BatchShard.of(1))[:3]}
        for task in TASKS:
            batch = ddp.shard_batch(torch_batch(arrays, task), rank, WORLD)
            res[task] = _two_steps(cfg, task, batch, ddp.make_train_step)
        torch.save(res, f"{out_path}.{rank}")
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("ddp") / "rank")
    mp.spawn(_worker, args=(_free_port(), out), nprocs=WORLD, join=True)
    ranks = [torch.load(f"{out}.{r}") for r in range(WORLD)]
    cfg = _cfg()
    arrays = tiny_train_arrays(cfg)
    whole = {task: _two_steps(cfg, task, torch_batch(arrays, task), tts.make_train_step)
             for task in TASKS}
    return cfg, ranks, whole


def test_ranks_know_their_videos(runs):
    _, ranks, _ = runs
    assert [r["shard"] for r in ranks] == [(0, 1, 2), (1, 1, 2)]


@pytest.mark.parametrize("task", TASKS)
def test_ddp_losses_equal_the_global_batch(runs, task):
    _, ranks, whole = runs
    want = whole[task][0]
    for r in ranks:
        got = r[task][0]
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (task, k, got[k], v)


@pytest.mark.parametrize("task", TASKS)
def test_ddp_params_and_ema_after_two_steps(runs, task):
    cfg, ranks, whole = runs
    init = tts.create_train_state(cfg, build_model(cfg, None, seed=4, device="cpu")).params
    for r in ranks:
        for i, what in ((1, "params"), (2, "ema")):
            got, want = r[task][i], whole[task][i]
            assert set(got) == set(want)
            for k, v in want.items():
                if zero_gradient_in_law(k, cfg):
                    moved = max(float((v - init[k]).abs().max()), float((got[k] - init[k]).abs().max()))
                    assert moved < cfg.train.lr, (task, what, k, moved)
                else:
                    err = float((got[k] - v).abs().max())
                    assert err <= 1e-5, (task, what, k, err)


def test_shard_batch_slices_videos_and_replicates_the_bank():
    cfg = _cfg()
    batch = torch_batch(tiny_train_arrays(cfg, B=3), "detection")
    parts = [ddp.shard_batch(batch, r, 2) for r in range(2)]
    assert [p.images.shape[0] for p in parts] == [2, 1]
    assert torch.equal(torch.cat([p.targets.masks for p in parts]), batch.targets.masks)
    assert torch.equal(torch.cat([p.prompt_category_embs for p in parts]),
                       batch.prompt_category_embs)
    assert all(torch.equal(p.category_bank, batch.category_bank) for p in parts)
    assert [ddp.shard_slice(5, r, 3) for r in range(3)] == [slice(0, 2), slice(2, 4), slice(4, 5)]


def test_a_rank_draws_its_slice_of_the_global_draws():
    """The per-video and per-row draws of the video at offset 1 of 3 equal
    the global batch's draws of that video (no collective is involved)."""
    cfg = _cfg()
    key = make_key(8, device="cpu")
    sh = ddp.BatchShard(offset=1, local=1, total=3, distributed=True)
    whole = ddp.BatchShard.whole(3)
    assert [k.path for k in sh.split(key)] == [k.path for k in whole.split(key)[1:2]]
    # PointRend rows, row-major over the videos (5 rows a video)
    logits = torch.randn(15, 8, 8, generator=torch.Generator().manual_seed(0))
    want = tc.uncertainty_point_coords(logits, cfg.train, key)[5:10]
    got = tc.uncertainty_point_coords(logits[5:10], cfg.train, key, sh)
    assert torch.equal(got, want)
    # the sot prompt draws and the PE coin
    draws_g, coin_g = draw_train_prompts(key, 3, 2, 4, 16)
    draws_l, coin_l = draw_train_prompts(key, 1, 2, 4, 16, sh)
    assert coin_l == coin_g and draws_l[0].key_fid == draws_g[1].key_fid
    assert torch.equal(draws_l[0].priority, draws_g[1].priority)
