"""A training run of the port resumed from ``save_checkpoint`` at step k
takes the same step k + 1 as the uninterrupted run: masters, moments,
EMA and the working model's parameters bit for bit (tiny training
config, detection, the port's own draws)."""

import numpy as np
import pytest
import torch

from torch_train_util import tiny_train_arrays, torch_batch, train_cfgs
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.parallel.train_state import create_train_state, make_train_step
from univs_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from univs_tpu_torch.utils.draws import make_key

torch.set_num_threads(1)


def _fresh(cfg):
    model = build_model(cfg, None, seed=5, device="cpu")
    return model, create_train_state(cfg, model), make_train_step(cfg, model, "detection")


@pytest.mark.parametrize("k", [1, 2])
def test_resume_equals_uninterrupted(tmp_path, k):
    _, cfg = train_cfgs()
    batch = torch_batch(tiny_train_arrays(cfg, seed=1), "detection")
    key = make_key(11, device="cpu")

    model, state, step = _fresh(cfg)
    for _ in range(k + 1):
        state, logged = step(state, batch, key)
    want = state

    model2, state2, step2 = _fresh(cfg)
    for _ in range(k):
        state2, _ = step2(state2, batch, key)
    path = tmp_path / "ckpt" / f"step{k}.pt"
    save_checkpoint(str(path), state2)

    model3, state3, step3 = _fresh(cfg)
    state3 = load_checkpoint(str(path), model3)
    assert state3.step == k
    state3, logged3 = step3(state3, batch, key)
    assert state3.step == want.step
    assert float(logged3["total_loss"]) == float(logged["total_loss"])
    for attr in ("params", "mu", "nu", "ema_params"):
        a, b = getattr(state3, attr), getattr(want, attr)
        assert set(a) == set(b)
        for n in a:
            assert torch.equal(a[n], b[n]), (attr, n)
    for (n, p), (_, q) in zip(model3.named_parameters(), model.named_parameters()):
        assert torch.equal(p, q), n


def test_load_refuses_a_model_of_other_parameters(tmp_path):
    _, cfg = train_cfgs()
    _, state, _ = _fresh(cfg)
    path = tmp_path / "s.pt"
    save_checkpoint(str(path), state)
    other = build_model(cfg, None, seed=5, device="cpu")  # frozen BN not promoted
    with pytest.raises(KeyError):
        load_checkpoint(str(path), other)
    cpu = load_checkpoint(str(path))
    assert cpu.step == 0 and set(cpu.params) == set(state.params)
    assert all(np.array_equal(cpu.params[n].numpy(), state.params[n].numpy()) for n in cpu.params)
