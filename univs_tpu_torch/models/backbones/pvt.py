"""PVTv2 backbone (counterpart of ``univs_tpu/models/backbones/pvt.py``),
NHWC at the module boundary, tokens ``[B, h*w, C]`` inside.

Overlapping patch embeddings (7x7/4, then 3x3/2), spatial-reduction
attention, Mix-FFN with a 3x3 depthwise conv, per-stage LayerNorm
outputs res2..res5.  Two SRA flavours, as in the JAX module:
``linear=False`` reduces K/V with a strided sr x sr conv padded as
flax's default "SAME" (none at sr_ratio 1); ``linear=True`` (``build_pvt``'s default, the reference's
only registered builder) pools K/V to 7x7 with the AdaptiveAvgPool law,
then 1x1 conv, LayerNorm and GELU at every stage, and puts a ReLU after
the Mix-FFN's ``fc1``.  GELUs are exact (erf); every LayerNorm has eps
1e-6 and runs in float32 (``LayerNorm32``).  Module names follow the
flax tree (``patch_embed{s}``, ``patch_norm{s}``, ``stage{s}_block{b}``
with ``norm1`` / ``attn.{q,sr,sr_norm,kv,proj}`` / ``norm2`` /
``mlp.{fc1,dwconv,fc2}``, ``out_norm{s}``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from univs_tpu_torch.models.backbones.resnet import pad_same
from univs_tpu_torch.models.transformer_layers import LayerNorm32

VARIANTS = {
    "pvt_v2_b0": dict(dims=(32, 64, 160, 256), depths=(2, 2, 2, 2), heads=(1, 2, 5, 8)),
    "pvt_v2_b1": dict(dims=(64, 128, 320, 512), depths=(2, 2, 2, 2), heads=(1, 2, 5, 8)),
    "pvt_v2_b2": dict(dims=(64, 128, 320, 512), depths=(3, 4, 6, 3), heads=(1, 2, 5, 8)),
    "pvt_v2_b3": dict(dims=(64, 128, 320, 512), depths=(3, 4, 18, 3), heads=(1, 2, 5, 8)),
    "pvt_v2_b5": dict(dims=(64, 128, 320, 512), depths=(3, 6, 40, 3), heads=(1, 2, 5, 8)),
}
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIOS = (8, 8, 4, 4)


def _nchw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:  # [B, h*w, C] -> NCHW view
    return x.reshape(x.shape[0], h, w, x.shape[-1]).permute(0, 3, 1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:  # NCHW -> [B, h*w, C]
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


class SRAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, linear: bool = False):
        super().__init__()
        self.num_heads, self.sr_ratio, self.linear = num_heads, sr_ratio, linear
        self.q = nn.Linear(dim, dim)
        if linear:
            self.sr = nn.Conv2d(dim, dim, 1)
        elif sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
        if linear or sr_ratio > 1:
            self.sr_norm = LayerNorm32(dim, eps=1e-6)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        q = self.q(x).reshape(B, N, H, hd).transpose(1, 2)
        if self.linear:
            xm = F.adaptive_avg_pool2d(_nchw(x, h, w), 7)
            kv_in = F.gelu(self.sr_norm(_tokens(self.sr(xm))))
        elif self.sr_ratio > 1:
            xm = pad_same(_nchw(x, h, w), self.sr_ratio, self.sr_ratio)
            kv_in = self.sr_norm(_tokens(self.sr(xm)))
        else:
            kv_in = x
        kv = self.kv(kv_in).reshape(B, -1, 2, H, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]  # [B, H, Nk, hd]
        logits = (q @ k.transpose(-1, -2)).to(torch.float32) / (hd ** 0.5)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, linear: bool = False):
        super().__init__()
        self.linear = linear
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        y = self.fc1(x)
        if self.linear:
            y = F.relu(y)
        y = F.gelu(_tokens(self.dwconv(_nchw(y, h, w))))
        return self.fc2(y)


class PVTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int, linear: bool):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio, linear)
        self.norm2 = LayerNorm32(dim, eps=1e-6)
        self.mlp = MixFFN(dim, dim * mlp_ratio, linear)

    def forward(self, x, h, w):
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.mlp(self.norm2(x), h, w)


class PVTv2(nn.Module):
    """[N, H, W, 3] normalized images -> {res2..res5} NHWC."""

    def __init__(self, dims: Tuple[int, ...] = (64, 128, 320, 512),
                 depths: Tuple[int, ...] = (3, 4, 6, 3), num_heads: Tuple[int, ...] = (1, 2, 5, 8),
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 linear: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        self.out_features = tuple(out_features)
        self.out_channels = {f"res{s + 2}": d for s, d in enumerate(dims)}
        cin = 3
        for s in range(4):
            k, stride, pad = (7, 4, 3) if s == 0 else (3, 2, 1)
            setattr(self, f"patch_embed{s}", nn.Conv2d(cin, dims[s], k, stride=stride, padding=pad))
            setattr(self, f"patch_norm{s}", LayerNorm32(dims[s], eps=1e-6))
            for b in range(depths[s]):
                setattr(self, f"stage{s}_block{b}",
                        PVTBlock(dims[s], num_heads[s], SR_RATIOS[s], MLP_RATIOS[s], linear))
            setattr(self, f"out_norm{s}", LayerNorm32(dims[s], eps=1e-6))
            cin = dims[s]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        dtype = self.patch_embed0.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        outs = {}
        for s in range(4):
            x = getattr(self, f"patch_embed{s}")(x)
            B, C, h, w = x.shape
            t = getattr(self, f"patch_norm{s}")(_tokens(x))
            for b in range(self.depths[s]):
                t = getattr(self, f"stage{s}_block{b}")(t, h, w)
            t = getattr(self, f"out_norm{s}")(t).reshape(B, h, w, C)
            if f"res{s + 2}" in self.out_features:
                outs[f"res{s + 2}"] = t
            x = t.permute(0, 3, 1, 2)
        return outs


def build_pvt(name: str = "pvt_v2_b2", linear: bool = True) -> PVTv2:
    """``linear=True`` as the reference's only registered builder."""
    if name not in VARIANTS:
        raise ValueError(f"unknown backbone {name!r}")
    v = VARIANTS[name]
    return PVTv2(dims=v["dims"], depths=v["depths"], num_heads=v["heads"], linear=linear)
