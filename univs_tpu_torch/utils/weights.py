"""Weights for the port: the bridge from a flax param tree, and the
port's own seeded init.

Bridge (``state_dict_from_flax``): the port's modules carry the flax
tree's names, so a flax path ``a/b/c/kernel`` lands on the torch key
``a.b.c.weight``.  Leaf rules (names and layouts as in
``univs_tpu/utils/convert.py:41-140`` and ``convert_univs.py:55-222``,
read in the other direction):

- Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
- LayerNorm / GroupNorm ``scale`` -> ``weight``; ``bias`` -> ``bias``;
- FrozenBN ``{scale, bias, mean, var}`` -> ``{weight, bias,
  running_mean, running_var}``;
- the pixel decoder's (and the VL pixel decoder's) ``level_embed_{i}``
  [C] -> rows of ``level_embed`` [L, C] (the reference's
  ``transformer.level_embed``);
- a depthwise Conv ``kernel`` HWIO ``[3, 3, 1, hidden]`` -> OIHW
  ``[hidden, 1, 3, 3]`` by the same transpose (PVT's ``dwconv``);
- MultiHeadAttention q/k/v/out Denses -> the four Linears of the same
  names (``transformer_layers.py:27-72``);
- any other leaf (``query_feat``, ``cls_temp``, Swin's
  ``relative_position_bias_table``, VLFuse's ``gamma_v`` / ``gamma_l``
  ...) as it is.

``load_state_dict_strict`` raises on a key left unmapped on either side
and on any shape mismatch.

Init (``init_params``): flax's defaults (LeCun-normal kernels, zero
biases, unit norms, N(0, 1) embeddings) from a ``torch.Generator``; the
CLIP text tower's raw parameters from the JAX package's initializers
(token embedding N(0, 0.02), positional N(0, 0.01), projection
N(0, width^-0.5)); Swin's bias tables as truncated N(0, 0.02) and
VLFuse's gammas as the constant 1/6 (``swin.py:60-65``,
``pixel_decoder_vl.py:99-100``); and the deformable-DETR init of the sampling offsets (zero kernel, the
direction-grid bias — ``pixel_decoder.py:48-64``) and of the attention
weights (zero).  Without it the sampling kernels would sample at
degenerate offsets.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn


def msda_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Direction-grid sampling-offset bias: head h points along angle
    2*pi*h/H, scaled 1..n_points per point, replicated over levels
    (reference: ops/modules/ms_deform_attn.py:66-74)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


# ---------------------------------------------------------------------------
# flax tree -> state_dict
# ---------------------------------------------------------------------------

_LEVEL_EMBED = re.compile(r"^level_embed_(\d+)$")


def state_dict_from_flax(tree: Mapping) -> Dict[str, np.ndarray]:
    """Nested dicts of arrays (a flax param tree) -> flat numpy state_dict."""
    out: Dict[str, np.ndarray] = {}

    def key(path, name):
        return ".".join(list(path) + [name])

    def walk(node: Mapping, path):
        level_embeds = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                if {"mean", "var"} <= set(v):  # FrozenBN
                    out[key(path + [k], "weight")] = np.asarray(v["scale"])
                    out[key(path + [k], "bias")] = np.asarray(v["bias"])
                    out[key(path + [k], "running_mean")] = np.asarray(v["mean"])
                    out[key(path + [k], "running_var")] = np.asarray(v["var"])
                    extra = set(v) - {"scale", "bias", "mean", "var"}
                    if extra:
                        raise KeyError(f"unmapped FrozenBN leaves {sorted(extra)} at {path + [k]}")
                else:
                    walk(v, path + [k])
                continue
            a = np.asarray(v)
            m = _LEVEL_EMBED.match(k)
            if m:
                level_embeds[int(m.group(1))] = a
            elif k == "kernel" and a.ndim == 2:
                out[key(path, "weight")] = a.T
            elif k == "kernel" and a.ndim == 4:
                out[key(path, "weight")] = a.transpose(3, 2, 0, 1)
            elif k == "kernel":
                raise KeyError(f"kernel of rank {a.ndim} at {path}")
            elif k == "scale":
                out[key(path, "weight")] = a
            else:
                out[key(path, k)] = a
        if level_embeds:
            if sorted(level_embeds) != list(range(len(level_embeds))):
                raise KeyError(f"level_embed_i not contiguous at {path}")
            out[key(path, "level_embed")] = np.stack([level_embeds[i] for i in range(len(level_embeds))])

    walk(tree, [])
    return out


def flax_leaf_of(model: nn.Module, key: str) -> List[Tuple[Tuple[str, ...], int]]:
    """The flax leaves (path, rank) that ``state_dict_from_flax`` maps onto
    the state_dict ``key``: the bridge's leaf rules read backwards (a
    Linear / Conv ``weight`` from ``kernel``, a norm's ``weight`` from
    ``scale``, FrozenBN's four tensors from scale / bias / mean / var, the
    pixel decoders' ``level_embed`` rows from ``level_embed_{i}``, any
    other leaf from itself)."""
    from univs_tpu_torch.models.backbones.resnet import FrozenBatchNorm

    mod_path, name = key.rsplit(".", 1) if "." in key else ("", key)
    mod = model.get_submodule(mod_path)
    t = mod._parameters.get(name)
    if t is None:
        t = mod._buffers[name]
    path = tuple(mod_path.split(".")) if mod_path else ()
    if isinstance(mod, FrozenBatchNorm):
        leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}[name]
        return [(path + (leaf,), 1)]
    if name == "weight" and isinstance(mod, (nn.Linear, nn.Conv2d)):
        return [(path + ("kernel",), t.dim())]
    if name == "weight" and isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
        return [(path + ("scale",), 1)]
    if name == "level_embed" and mod_path.startswith("pixel_decoder"):
        return [(path + (f"level_embed_{i}",), 1) for i in range(t.shape[0])]
    return [(path + (name,), t.dim())]


def load_state_dict_strict(model: nn.Module, state: Mapping) -> None:
    """Load numpy or torch arrays into ``model``; raise on any key that is
    missing or unexpected, and on any shape mismatch."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"weight bridge: unmapped keys — missing in source: {missing[:20]}"
                       f"{' ...' if len(missing) > 20 else ''}; not in model: "
                       f"{unexpected[:20]}{' ...' if len(unexpected) > 20 else ''}")
    bad = [k for k in own if tuple(own[k].shape) != tuple(np.shape(state[k]))]
    if bad:
        raise ValueError("weight bridge: shape mismatch at " + ", ".join(
            f"{k} {tuple(own[k].shape)} vs {tuple(np.shape(state[k]))}" for k in bad[:20]))
    converted = {k: (v if torch.is_tensor(v) else torch.as_tensor(np.array(v)))
                 .to(dtype=own[k].dtype) for k, v in state.items()}
    model.load_state_dict(converted, strict=True)


# ---------------------------------------------------------------------------
# the port's seeded init
# ---------------------------------------------------------------------------


def _truncated_normal_(w: torch.Tensor, g: torch.Generator, std: float) -> None:
    """Normal samples redrawn until within +-2, times ``std``."""
    x = torch.randn(w.shape, generator=g)
    while True:
        bad = x.abs() > 2.0
        if not bad.any():
            break
        x[bad] = torch.randn(int(bad.sum()), generator=g)
    w.copy_(x * std)


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in = w[0].numel()  # Linear [out, in], Conv [out, in / groups, kh, kw]
    # flax lecun_normal: truncated normal (+-2 std) rescaled to unit variance
    _truncated_normal_(w, g, math.sqrt(1.0 / fan_in) / 0.87962566103423978)


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> None:
    """Seeded init of every parameter of a port model (see module doc)."""
    from univs_tpu_torch.models.backbones.resnet import FrozenBatchNorm
    from univs_tpu_torch.models.backbones.swin import WindowAttention
    from univs_tpu_torch.models.clip_text import ClipTextEncoder
    from univs_tpu_torch.models.decoder import UniVSDecoder
    from univs_tpu_torch.models.pixel_decoder import MSDeformAttnLayer, MSDeformAttnPixelDecoder
    from univs_tpu_torch.models.pixel_decoder_vl import VLFuse

    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(mod.weight, g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, FrozenBatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    # second pass: modules' own laws override the generic ones
    for mod in model.modules():
        if isinstance(mod, MSDeformAttnLayer):
            so, aw = mod.sampling_offsets, mod.attention_weights
            so.weight.zero_()
            so.bias.copy_(torch.as_tensor(msda_offset_bias(mod.n_heads, mod.n_levels, mod.n_points)))
            aw.weight.zero_()
            aw.bias.zero_()
        elif isinstance(mod, MSDeformAttnPixelDecoder):
            mod.level_embed.copy_(torch.randn(mod.level_embed.shape, generator=g))
        elif isinstance(mod, UniVSDecoder):
            for p in (mod.query_feat, mod.query_embed, mod.level_embed):
                p.copy_(torch.randn(p.shape, generator=g))
            for p in (mod.cls_temp, mod.reid_temp):
                p.fill_(math.log(1 / 0.07))
            for p in (mod.prompt_detection, mod.prompt_sot, mod.prompt_grounding):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        elif isinstance(mod, WindowAttention):
            _truncated_normal_(mod.relative_position_bias_table, g, 0.02)
        elif isinstance(mod, VLFuse):
            mod.gamma_v.fill_(1 / 6)
            mod.gamma_l.fill_(1 / 6)
        elif isinstance(mod, ClipTextEncoder):
            for p, std in ((mod.token_embedding, 0.02), (mod.positional_embedding, 0.01),
                           (mod.text_projection, mod.width ** -0.5)):
                p.copy_(torch.randn(p.shape, generator=g) * std)
