"""Checkpoints of a ``TrainState`` with ``torch.save`` (counterpart of
``univs_tpu/utils/checkpoint.py``, which writes orbax pytrees).

A checkpoint holds the step, the float32 master params, Adam's two
moments and the EMA, all on the CPU.  ``load_checkpoint`` puts them on
the working model's device and copies the masters into the working
model with rounding, as a step does, so a run resumed at step k takes
the same step k + 1 as an uninterrupted run (the train step's draws are
a function of the key and the step, not of a generator's history).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn

from univs_tpu_torch.parallel.train_state import TrainState


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` (a file; parent directories made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    torch.save({"step": int(state.step), "params": cpu(state.params), "mu": cpu(state.mu),
                "nu": cpu(state.nu), "ema_params": cpu(state.ema_params)}, path)


def load_checkpoint(path: str, model: Optional[nn.Module] = None, device=None) -> TrainState:
    """Read a state written by ``save_checkpoint``.  With ``model`` (the
    working model of a ``create_train_state``), the tensors go to its
    device and its parameters take the masters; else to ``device``
    (default the CPU)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    named = dict(model.named_parameters()) if model is not None else {}
    if model is not None and set(named) != set(blob["params"]):
        missing = sorted(set(named) ^ set(blob["params"]))
        raise KeyError(f"checkpoint and model disagree on parameters: {missing[:10]}")
    dev = next(iter(named.values())).device if named else torch.device(device or "cpu")
    put = lambda d: {k: v.to(dev) for k, v in d.items()}
    state = TrainState(step=int(blob["step"]), params=put(blob["params"]), mu=put(blob["mu"]),
                       nu=put(blob["nu"]), ema_params=put(blob["ema_params"]))
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(state.params[k])
    return state
