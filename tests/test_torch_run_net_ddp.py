"""``run_net --train`` under ``torchrun``: two gloo processes on the CPU
call the port's ``run_net.main(argv)`` with torchrun's environment
(RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT), ``--tiny
--device cpu``, over one synthetic ytvis tree, and train the global
batch: the logged losses equal a one-process CLI run's on the same tree
within 1e-5 x max(1, |v|), ``ckpt_final``'s float32 masters within 1e-5
(the biases whose gradient is 0 in exact arithmetic move by rounding noise
only, less than one step), as ``test_torch_ddp.py`` holds the step.  Only
rank 0 writes and prints; ``--resume`` restarts at the saved step on
every rank; a ``--batch-size`` the world does not divide is refused.

The one-process CLI is held to JAX's tool by ``test_torch_entry.py``,
and the data-parallel step to the one-process step by
``test_torch_ddp.py``; no JAX step is compiled here."""

import json
import os

import pytest
import torch
import torch.multiprocessing as mp

from torch_tools_util import free_port, run_net_argv, run_net_cli, run_net_worker, write_ytvis_tree
from univs_tpu_torch.parallel import ddp
from univs_tpu_torch.tools import run_net

torch.set_num_threads(1)

WORLD = 2  # the ranks of torch_tools_util.run_net_worker
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("run_net_ddp"))
    write_ytvis_tree(root)
    with pytest.MonkeyPatch.context() as m:
        m.setenv("UNIVS_TPU_DATA_ROOT", root)
        world = os.path.join(root, "world")
        ranks = mp.spawn(run_net_worker, args=([free_port() for _ in range(3)], root, world),
                         nprocs=WORLD, join=False)
        one = os.path.join(root, "one")  # while the ranks run
        run_net_cli(run_net_argv(one, 2))
        while not ranks.join():
            pass
    return one, world, [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(WORLD)]


def _jsonl(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _masters(path):
    return torch.load(os.path.join(path, "ckpt_final"), weights_only=True)


def test_world_losses_equal_the_one_process_cli(runs):
    one, world, _ = runs
    want, got = _jsonl(one), _jsonl(world)
    # rank 0 alone wrote: one line a log step (it 0 of the first run, none
    # at it 2 of the resumed run: JAX's cadence it % 20 == 0)
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] == [0]
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        assert abs(got[0][k] - v) <= LOSS_TOL * max(1.0, abs(v)), (k, got[0][k], v)


def test_world_ckpt_final_equals_the_one_process_cli(runs):
    from torch_train_util import zero_gradient_in_law

    one, world, _ = runs
    want = _masters(one)
    got = torch.load(world + "_ckpt_final_2", weights_only=True)  # before the resume
    assert want["step"] == got["step"] == 2
    cfg, _ = run_net.build_cfg(run_net.parse_args(["--tiny"]))
    init = run_net.initial_params(cfg, 0)
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        if zero_gradient_in_law(k, cfg):
            moved = max(float((v - init[k]).abs().max()),
                        float((got["params"][k] - init[k]).abs().max()))
            assert moved < cfg.train.lr, (k, moved)
        else:
            err = float((got["params"][k] - v).abs().max())
            assert err <= PARAM_TOL, (k, err)
    final = _masters(world)
    assert final["step"] == 3 and set(final["params"]) == set(want["params"])


def test_only_rank_0_writes_and_prints(runs):
    _, world, ranks = runs
    assert sorted(os.listdir(world)) == ["ckpt_final", "metrics.jsonl", "state_2"]
    assert "iter 0" in ranks[0]["train"] and ranks[1]["train"] == ""
    assert ranks[1]["resume"] == ""


def test_resume_restarts_at_the_saved_step(runs):
    _, _, ranks = runs
    assert "resumed full train state" in ranks[0]["resume"] and "(iter 2)" in ranks[0]["resume"]


def test_indivisible_batch_is_refused(runs):
    _, _, ranks = runs
    for r in ranks:
        assert "--batch-size 3 does not split over 2" in r["refused"]


def test_world_of_one_without_torchrun():
    env = {"PATH": "/usr/bin"}
    w = ddp.init_from_env("cpu", None, environ=env)
    assert (w.rank, w.size, w.device, w.distributed) == (0, 1, torch.device("cpu"), False)
    w.close()
    with pytest.raises(ValueError, match="gloo"):
        ddp.init_from_env("cpu", "nccl", environ=dict(RANK="0", WORLD_SIZE="2"))
    assert ddp.rank_device("cpu", 3) == torch.device("cpu")
