"""Swin Transformer backbone (counterpart of
``univs_tpu/models/backbones/swin.py``), NHWC at the module boundary.

Window partition and shift by reshapes and ``torch.roll``; attention as
batched matrix products with the relative-position bias gathered from
its float32 table.  The laws and rounding points are the JAX module's:

- window padding happens inside the block, after ``norm1``, with zeros,
  and the attention output is cropped before the residual, so the zero
  keys take part in every window's softmax (``swin.py:94-120``);
- the shift mask is labelled in the post-roll space of the padded map,
  -100 between regions (``_shift_mask``, copied);
- q.k^T in the compute dtype, cast to float32, divided by sqrt(hd) (q is
  not pre-scaled), plus the float32 bias ``rpb[idx]`` and the shift
  mask, softmax in float32, cast to v's dtype, product with v; the
  logits are viewed as ``(-1, nW, H, w^2, w^2)`` so the windows stay
  frame-major;
- every LayerNorm runs in float32 with float32 scale and bias
  (``LayerNorm32``) and the bias table is float32: the model builders
  keep these parameters in float32 when they cast the model to bf16;
- the 4x4/4 patch embedding pads as flax's default "SAME" (sizes that
  are not multiples of 4);
- patch merging pads odd sizes, then concatenates (0,0), (1,0), (0,1),
  (1,1); GELU is exact (erf).

Module names follow the flax tree (``patch_embed``, ``stage{s}_block{b}``
with ``norm1`` / ``attn.{qkv,proj,relative_position_bias_table}`` /
``norm2`` / ``fc1`` / ``fc2``, ``out_norm{s}``, ``merge_norm{s}``,
``merge_reduction{s}``), so the weight bridge maps them one to one.

Geometry per variant: tiny dim 96, depths (2,2,6,2), heads (3,6,12,24);
small dim 96, (2,2,18,2); base dim 128, (2,2,18,2), (4,8,16,32); large
dim 192, (2,2,18,2), (6,12,24,48).  Strides res2=4 ... res5=32.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from univs_tpu_torch.models.backbones.resnet import pad_same
from univs_tpu_torch.models.transformer_layers import LayerNorm32

VARIANTS = {
    "swin_tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


def _rel_pos_index(w: int) -> np.ndarray:
    """Relative position index table for a w x w window -> [w*w, w*w]."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + np.array([w - 1, w - 1])
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def _shift_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """Additive attention mask for shifted windows [nW, 1, w2, w2] on the
    padded H x W map.  Region labels are assigned in the post-roll space
    (the reference builds its image mask on the padded map without
    rolling): only the last window row and column mix regions."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] != win[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)[:, None]


@functools.lru_cache(maxsize=64)
def _shift_mask_on(H: int, W: int, w: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_shift_mask(H, W, w, shift), device=device)


class WindowAttention(nn.Module):
    keep_float32 = ("relative_position_bias_table",)

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.as_tensor(_rel_pos_index(window).reshape(-1),
                                                          dtype=torch.int64), persistent=False)

    def forward(self, x: torch.Tensor, bias) -> torch.Tensor:
        """x: [nW_total, w*w, C]; bias: additive float32 [nW, 1, w*w, w*w]
        (the windows of one frame) or None."""
        w2 = self.window * self.window
        H = self.num_heads
        hd = self.dim // H
        qkv = self.qkv(x).reshape(*x.shape[:-1], 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [b, H, w2, hd]
        rpb = self.relative_position_bias_table.to(torch.float32)
        rel_bias = rpb[self.rel_index].reshape(w2, w2, H).permute(2, 0, 1)  # [H, w2, w2]
        logits = (q @ k.transpose(-1, -2)).to(torch.float32)
        logits.div_(math.sqrt(hd)).add_(rel_bias[None])
        if bias is not None:
            nW = bias.shape[0]
            logits = logits.view(-1, nW, H, w2, w2).add_(bias[None]).view(-1, H, w2, w2)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        del logits
        out = (attn @ v).transpose(1, 2).reshape(*x.shape[:-1], self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C], unpadded; padded inside, after norm1."""
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        ph, pw = (w - H % w) % w, (w - W % w) % w
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        yw = y.reshape(B, Hp // w, w, Wp // w, w, C).transpose(2, 3).reshape(-1, w * w, C)
        bias = _shift_mask_on(Hp, Wp, w, s, x.device) if s > 0 else None
        yw = self.attn(yw, bias)
        y = yw.reshape(B, Hp // w, Wp // w, w, w, C).transpose(2, 3).reshape(B, Hp, Wp, C)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y[:, :H, :W]
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + y


class SwinTransformer(nn.Module):
    """[N, H, W, 3] normalized images -> {res2..res5} NHWC."""

    def __init__(self, embed_dim: int = 96, depths: Tuple[int, ...] = (2, 2, 6, 2),
                 num_heads: Tuple[int, ...] = (3, 6, 12, 24), window: int = 7,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.depths = tuple(depths)
        self.out_features = tuple(out_features)
        self.out_channels = {f"res{s + 2}": embed_dim * 2 ** s for s in range(len(depths))}
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = LayerNorm32(embed_dim, eps=1e-5)
        dim = embed_dim
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}",
                        SwinBlock(dim, num_heads[s], window, 0 if b % 2 == 0 else window // 2))
            if f"res{s + 2}" in self.out_features:
                setattr(self, f"out_norm{s}", LayerNorm32(dim, eps=1e-5))
            if s < len(self.depths) - 1:
                setattr(self, f"merge_norm{s}", LayerNorm32(4 * dim, eps=1e-5))
                setattr(self, f"merge_reduction{s}", nn.Linear(4 * dim, 2 * dim, bias=False))
                dim *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        dtype = self.patch_embed.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.patch_norm(self.patch_embed(pad_same(x, 4, 4)).permute(0, 2, 3, 1))
        outs = {}
        # activation checkpointing (JAX: nn.remat(SwinBlock)): a block's
        # activations are recomputed in the backward; a block draws nothing
        # (no dropout, no drop path), so the recompute is the forward exactly
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                block = getattr(self, f"stage{s}_block{b}")
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            name = f"res{s + 2}"
            if name in self.out_features:
                outs[name] = getattr(self, f"out_norm{s}")(x)
            if s < len(self.depths) - 1:
                H, W = x.shape[1:3]
                if H % 2 or W % 2:
                    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                               x[:, 1::2, 1::2]], dim=-1)
                x = getattr(self, f"merge_reduction{s}")(getattr(self, f"merge_norm{s}")(x))
        return outs


def build_swin(cfg) -> SwinTransformer:
    """From a BackboneConfig: ``VARIANTS[cfg.name]``,
    ``cfg.swin_window_size`` and ``cfg.swin_use_checkpoint``
    (``swin_drop_path_rate`` is read by no JAX module: JAX's Swin has no
    drop path)."""
    if cfg.name not in VARIANTS:
        raise ValueError(f"unknown backbone {cfg.name!r}")
    v = VARIANTS[cfg.name]
    return SwinTransformer(embed_dim=v["embed_dim"], depths=v["depths"], num_heads=v["num_heads"],
                           window=cfg.swin_window_size, out_features=cfg.out_features,
                           use_checkpoint=cfg.swin_use_checkpoint)
