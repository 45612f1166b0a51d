"""Training's parallel layer (counterpart of ``univs_tpu/parallel``):
``make_mesh`` (``mesh.py``), and the train state and step
(``train_state.py``), exported by name as JAX's package does.  The train
step's names load on first use, because ``train_state`` imports the
criterion, which imports ``ddp`` from this package."""

import importlib

from univs_tpu_torch.parallel.mesh import make_mesh  # noqa: F401

_LAZY = ("TrainState", "make_train_step", "create_train_state")

__all__ = ["make_mesh", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.train_state"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
