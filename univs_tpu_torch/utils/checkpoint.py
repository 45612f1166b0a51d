"""Checkpoints of a ``TrainState`` with ``torch.save``, and weight intake
(counterpart of ``univs_tpu/utils/checkpoint.py``, which writes orbax
pytrees).

A checkpoint holds the step, the float32 master params, Adam's two
moments and the EMA, all on the CPU.  ``load_checkpoint`` puts them on
the working model's device and copies the masters into the working
model with rounding, as a step does, so a run resumed at step k takes
the same step k + 1 as an uninterrupted run (the train step's draws are
a function of the key and the step, not of a generator's history).

Intake: ``load_params`` reads a reference UniVS checkpoint (``.pth`` /
``.pkl`` / ``.pt``, through ``utils/convert_univs.py`` and
``utils/weights.state_dict_from_flax``), any other torch file or ``.npz``
as its flat dict, and a file of ``save_checkpoint`` or ``save_params`` as
its float32 masters; ``load_category_bank`` finds the frozen CLIP category
bank or makes the JAX package's seeded random one.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from univs_tpu_torch.parallel.train_state import TrainState


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` (a file; parent directories made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    torch.save({"step": int(state.step), "params": cpu(state.params), "mu": cpu(state.mu),
                "nu": cpu(state.nu), "ema_params": cpu(state.ema_params)}, path)


def save_params(path: str, state: TrainState) -> None:
    """Write the float32 master params of ``state`` alone (the trainer's
    ``ckpt_final``, as the JAX tool saves ``state.params``); read back by
    ``load_params``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"step": int(state.step),
                "params": {k: v.detach().cpu() for k, v in state.params.items()}}, path)


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


def _written_by_trainer(blob) -> bool:
    """A ``save_checkpoint`` state or a ``save_params`` file."""
    return isinstance(blob, dict) and {"step", "params"} <= set(blob) \
        and isinstance(blob["params"], dict)


def load_params(path: str, cfg=None) -> Any:
    """Model weights from ``path``:

    - a reference UniVS checkpoint (``.pth`` / ``.pkl`` / ``.pt`` with keys
      under ``sem_seg_head.`` or ``teacher.sem_seg_head.``): converted
      (EMA teacher preferred, ``static_query`` renamed) into a state_dict
      that ``build_model(cfg, params)`` loads strictly; ``cfg`` gives the
      ResNet depth (50 without it, as the JAX package);
    - any other torch file of those suffixes: its flat numpy dict;
    - ``.npz``: its dict;
    - a file written by ``save_checkpoint`` or ``save_params`` (the
      trainer's ``state_*`` and ``ckpt_final``): its float32 master
      params, a state_dict.

    An orbax directory (the JAX package's format) is refused: reading it
    needs JAX."""
    from univs_tpu_torch.utils.convert import flatten_torch

    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package?): "
                         "reading orbax needs JAX; convert it to .npz or .pth first")
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=True))
    torch_file = path.endswith((".pth", ".pkl", ".pt"))
    try:
        blob = torch.load(path, map_location="cpu", weights_only=False)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:  # not a torch file
        if torch_file:
            raise
        raise ValueError(f"unknown checkpoint format: {path}") from e
    if _written_by_trainer(blob):
        return {k: v.float() for k, v in blob["params"].items()}
    if not torch_file:
        raise ValueError(f"unknown checkpoint format: {path}")
    flat = flatten_torch(blob)
    if any(k.startswith(("sem_seg_head.", "teacher.sem_seg_head.")) for k in flat):
        from univs_tpu_torch.utils.convert_univs import convert_univs_checkpoint
        from univs_tpu_torch.utils.weights import state_dict_from_flax

        depth = cfg.backbone.resnet_depth if cfg is not None else 50
        return state_dict_from_flax(convert_univs_checkpoint(flat, resnet_depth=depth))
    return flat


def load_category_bank(path: Optional[str], num_rows: int, dim: int = 640,
                       seed: int = 0) -> np.ndarray:
    """Load the frozen CLIP category-embedding bank
    (reference data: datasets/concept_emb/
    combined_datasets_cls_emb_rn50x4.pth, 3938x640).  When no path is
    given, tries $UNIVS_TPU_CLS_BANK then the in-repo extraction
    artifact; falls back to a seeded random bank (smoke/bench mode), the
    JAX package's bit for bit."""
    explicit = bool(path)
    if not path:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for cand in (
            os.environ.get("UNIVS_TPU_CLS_BANK", ""),
            os.path.join(repo, "artifacts", "combined_datasets_cls_emb_rn50x4_randinit.npy"),
        ):
            if cand and os.path.exists(cand):
                path = cand
                break
    log = logging.getLogger(__name__)
    if path and not explicit and "randinit" in os.path.basename(path):
        log.warning(
            "load_category_bank: no bank path configured — falling back to the "
            "RANDOM-INIT artifact %s. Class scores will be degraded; set "
            "UNIVS_TPU_CLS_BANK or cfg to a real CLIP-extracted bank for eval.",
            path,
        )
    if path and os.path.exists(path):
        if path.endswith(".npy"):
            bank = np.load(path)
        else:
            bank = torch.load(path, map_location="cpu", weights_only=False)
            bank = bank.numpy() if hasattr(bank, "numpy") else np.asarray(bank)
        if bank.shape[-1] == dim:
            return bank.astype(np.float32)
        # auto-discovered artifact with a different text width (e.g.
        # tiny test configs): fall through to the seeded random bank
    log.warning(
        "load_category_bank: using a seeded RANDOM bank (%dx%d) — smoke/bench "
        "mode only; class scores are meaningless.", num_rows, dim,
    )
    rng = np.random.RandomState(seed)
    bank = rng.randn(num_rows, dim).astype(np.float32)
    return bank / np.linalg.norm(bank, axis=-1, keepdims=True)
