"""The control of the comparison: the reference computed one precision
below the configuration's bfloat16, in fp8 (e4m3).  Every ``nn.Linear``
and ``nn.Conv2d`` weight of a copy of the reference is rounded to fp8
with one scale a tensor (its largest magnitude onto 448, e4m3's largest
finite value), and so is the input of every such module's call; all
arithmetic stays float32.  The products that bypass the modules' calls
(the pixel decoder's offset rows and FFN tail, which read the weights
directly) see the rounded weights and unrounded inputs."""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 under one per-tensor scale, back in x's dtype."""
    amax = x.detach().abs().amax().to(torch.float32)
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return ((x.to(torch.float32) / scale).to(torch.float8_e4m3fn).to(torch.float32)
            * scale).to(x.dtype)


def _round_input(_mod, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


def fp8_control(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose Linear / Conv2d weights and inputs are
    rounded to fp8."""
    ctl = copy.deepcopy(model)
    with torch.no_grad():
        for mod in ctl.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                mod.weight.copy_(fp8_round(mod.weight))
                mod.register_forward_pre_hook(_round_input)
    return ctl
