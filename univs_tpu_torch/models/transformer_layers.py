"""DETR-style attention blocks, batch-major (counterpart of
``univs_tpu/models/transformer_layers.py``).

q/k/v/out are separate ``nn.Linear`` layers named as the flax Dense
layers (``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``).  Attention
logits are float32; a boolean bias is an allow-mask applied as
``where(bias, logits, NEG_INF)``, a float bias is added.  NEG_INF is the
finite -1e9 of the JAX package (fully-masked rows stay finite).  Plain
matrix products, no fused attention kernel: the decoder holds no Pallas
kernel to port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e9


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value, bias: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        H = self.num_heads
        C = query.shape[-1]
        hd = C // H

        def heads(x, proj):  # [B, L, C] -> [B, H, L, hd]
            y = proj(x)
            return y.reshape(*y.shape[:-1], H, hd).transpose(-3, -2)

        q, k, v = heads(query, self.q_proj), heads(key, self.k_proj), heads(value, self.v_proj)
        logits = (q @ k.transpose(-1, -2)).to(torch.float32) / math.sqrt(hd)
        if bias is not None:
            if bias.dtype == torch.bool:
                # in place: the logits are this call's own, and an
                # out-of-place fill copies them whole ([B, H, Lq, Lk] float32)
                logits = logits.masked_fill_(~bias, NEG_INF)
            else:
                logits = logits + bias
        weights = torch.softmax(logits, dim=-1)
        out = (weights.to(v.dtype) @ v).transpose(-3, -2)  # [B, Lq, H, hd]
        out = self.out_proj(out.reshape(*out.shape[:-2], C))
        if return_weights:
            return out, weights.mean(dim=1)
        return out


class SelfAttentionBlock(nn.Module):
    """q=k=x+pos, v=x; residual + LayerNorm (post- or pre-norm)."""

    def __init__(self, d_model: int, num_heads: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.attn = MultiHeadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, pos=None, bias=None):
        if self.pre_norm:
            y = self.norm(x)
            qk = y if pos is None else y + pos
            return x + self.attn(qk, qk, y, bias)
        qk = x if pos is None else x + pos
        return self.norm(x + self.attn(qk, qk, x, bias))


class CrossAttentionBlock(nn.Module):
    """q=x+query_pos, k=mem+pos, v=mem; residual + LayerNorm."""

    def __init__(self, d_model: int, num_heads: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.attn = MultiHeadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, mem, query_pos=None, pos=None, bias=None, return_weights=False):
        if self.pre_norm:
            y = self.norm(x)
            q = y if query_pos is None else y + query_pos
        else:
            q = x if query_pos is None else x + query_pos
        k = mem if pos is None else mem + pos
        out = self.attn(q, k, mem, bias, return_weights=return_weights)
        attn_out, weights = out if return_weights else (out, None)
        res = x + attn_out
        res = res if self.pre_norm else self.norm(res)
        return (res, weights) if return_weights else res


class FFNBlock(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        def ffn(y):
            return self.linear2(F.relu(self.linear1(y)))

        if self.pre_norm:
            return x + ffn(self.norm(x))
        return self.norm(x + ffn(x))


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32 with float32 scale and bias, its
    result cast back to the input's dtype (flax ``LayerNorm(dtype=
    jnp.float32)`` on the JAX package's float32 params).  The model
    builders keep the parameters named in ``keep_float32`` in float32 when
    they cast a model to its compute dtype (``models/univs.py:_place``)."""

    keep_float32 = ("weight", "bias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight.to(torch.float32),
                         self.bias.to(torch.float32), self.eps)
        return y.to(x.dtype)


class MLP(nn.Module):
    """N-layer MLP with ReLU between layers (DETR's mask-embed head)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers):
            out = output_dim if i == num_layers - 1 else hidden_dim
            setattr(self, f"layer{i}", nn.Linear(dims[i], out))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return getattr(self, f"layer{self.num_layers - 1}")(x)
