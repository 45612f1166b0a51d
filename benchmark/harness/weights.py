"""Seeded weights, made on the device in one draw.

Names, shapes and module kinds come from the reference model (which
carries the program's parameter names); the values come from one
``torch.randn`` of every element at once on a ``torch.Generator`` of the
device, sliced and scaled by leaf:

- ``nn.Linear`` / ``nn.Conv2d`` weights N(0, 1 / fan_in), their biases
  N(0, 0.02^2);
- the deformable layers' sampling-offset bias: the direction grid of
  Deformable DETR (head h along angle 2 pi h / M, point p at p + 1) plus
  the N(0, 0.02^2) draw, so that the samples spread around each query;
- LayerNorm / GroupNorm / frozen BN: unit scale, zero shift, the BN's
  statistics 0 and 1;
- the decoder's query features, query and level embeddings and the
  pixel decoder's level embeddings N(0, 1); the prompt-type embeddings
  N(0, 0.02^2); the class and re-id temperatures log(1 / 0.07);
- a leaf only one backbone family has: its family's ``leaf_rule``
  (``reference/models/backbones/<family>.py``; Swin's relative-position
  bias tables N(0, 0.02^2)).

Every leaf the program holds in its compute dtype is rounded to it here,
so the program and the reference read the same numbers; the leaves a
module names in ``keep_float32`` stay float32.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.models.backbones import family
from benchmark.reference.models.backbones.resnet import FrozenBatchNorm
from benchmark.reference.models.decoder import UniVSDecoder
from benchmark.reference.models.pixel_decoder import MSDeformAttnLayer, MSDeformAttnPixelDecoder


def direction_grid(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Deformable DETR's sampling-offset bias [M * L * P * 2]."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def _leaf_rule(mod: nn.Module, leaf: str, family_rule=None):
    """(kind, scale) of one leaf: 'normal' (scale x the draw) or 'const'
    (scale everywhere); ``family_rule`` (the backbone family's
    ``leaf_rule``) is asked last."""
    if isinstance(mod, (nn.Linear, nn.Conv2d)):
        if leaf == "weight":
            return "normal", 1.0 / math.sqrt(mod.weight[0].numel())
        return "normal", 0.02
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)):
        return "const", {"weight": 1.0, "bias": 0.0, "running_mean": 0.0, "running_var": 1.0}[leaf]
    if isinstance(mod, UniVSDecoder):
        if leaf in ("query_feat", "query_embed", "level_embed"):
            return "normal", 1.0
        if leaf in ("cls_temp", "reid_temp"):
            return "const", math.log(1 / 0.07)
        if leaf.startswith("prompt_"):
            return "normal", 0.02
    if isinstance(mod, MSDeformAttnPixelDecoder) and leaf == "level_embed":
        return "normal", 1.0
    rule = family_rule(mod, leaf) if family_rule is not None else None
    if rule is not None:
        return rule
    raise KeyError(f"no seeded rule for {type(mod).__name__}.{leaf}")


@torch.no_grad()
def seeded_state(ref_model: nn.Module, seed: int, device, compute_dtype: torch.dtype
                 ) -> Dict[str, torch.Tensor]:
    """The state_dict of ``ref_model``'s names and shapes, drawn from
    ``seed`` on ``device``; leaves in ``compute_dtype`` unless their module
    keeps them in float32.  ``ref_model`` (a reference ``UniVSModel``) may
    live on the meta device."""
    family_rule = getattr(family(ref_model.cfg.backbone.name), "leaf_rule", None)
    persistent = set(ref_model.state_dict())
    leaves = []  # (key, module, leaf, tensor, kept in float32)
    for mod_name, mod in ref_model.named_modules():
        keep = getattr(mod, "keep_float32", ())
        for leaf, t in list(mod._parameters.items()) + list(mod._buffers.items()):
            if t is None:
                continue
            key = f"{mod_name}.{leaf}" if mod_name else leaf
            if key in persistent:
                leaves.append((key, mod, leaf, t, leaf in keep))
    total = sum(x[3].numel() for x in leaves)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    state, at = {}, 0
    offset_bias = {id(m.sampling_offsets): direction_grid(m.n_heads, m.n_levels, m.n_points)
                   for m in ref_model.modules() if isinstance(m, MSDeformAttnLayer)}
    for key, mod, leaf, t, keep in leaves:
        draw = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        kind, scale = _leaf_rule(mod, leaf, family_rule)
        if kind == "const":
            v = torch.full(t.shape, scale, device=device)
        else:
            v = draw * scale
        if leaf == "bias" and id(mod) in offset_bias:
            v = v + torch.as_tensor(offset_bias[id(mod)], device=device)
        state[key] = v if keep else v.to(compute_dtype)
    return state
