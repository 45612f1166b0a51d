"""Device selection for the port's entry points.

Entry points (``EntityDriver`` and the model builders) run on the card
unless the caller asks for the CPU explicitly.  With no card and no
explicit request they raise: a run never falls back to the CPU
silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is present); anything
    else is taken as given (``"cpu"`` is how tests ask for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "univs_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
