"""Multi-scale deformable-attention pixel decoder (encoder + FPN)
(counterpart of ``univs_tpu/models/pixel_decoder.py``), NHWC at the
module boundary.

Per encoder layer the deformable attention runs as three steps:
``msda_rows`` (offsets, weights, coordinates from the query tokens —
kernel B on CUDA), ``msda_sample`` (the bilinear weighted sum over all
levels — kernel A), and the output projection; the layer tail is
``fused_ffn_ln`` (kernel C).  On CUDA tensors the three kernels run, as
the TPU runs ``msda_sample_fused`` and ``fused_ffn_ln``
(``pixel_decoder.py:93-112,165-179``); on CPU tensors the plain laws run.
Reference points are the static pixel-centre grid (no padding masks),
rebuilt from the query index inside ``msda_rows``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.ops.plain import fused_ffn_ln, msda_rows, msda_sample
from benchmark.reference.ops.position_encoding import SinePositionEncoding3D


class MSDeformAttnLayer(nn.Module):
    """Offset/weight prediction + sampling + output projection
    (reference: ops/modules/ms_deform_attn.py:34-121)."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, value_src, spatial_shapes):
        N, Lq, C = query.shape
        M = self.n_heads
        value = self.value_proj(value_src).reshape(N, -1, M, C // M)
        # the ops take Dense kernels [in, out]: a view of nn.Linear's weight
        so, aw = self.sampling_offsets, self.attention_weights
        loc = msda_rows(query, so.weight.t(), so.bias, aw.weight.t(), aw.bias, spatial_shapes, M,
                        self.n_points)
        return self.output_proj(msda_sample(value, spatial_shapes, loc))


class DeformableEncoderLayer(nn.Module):
    """Deformable self-attn, then the fused residual+LN+FFN+LN tail
    (reference: msdeformattn.py:92-133, post-norm)."""

    def __init__(self, d_model=256, ffn_dim=1024, n_levels=3, n_heads=8, n_points=4):
        super().__init__()
        self.self_attn = MSDeformAttnLayer(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, spatial_shapes):
        attn_out = self.self_attn(src + pos, src, spatial_shapes)
        return fused_ffn_ln(
            src, attn_out, self.norm1.weight, self.norm1.bias,
            self.linear1.weight.t(), self.linear1.bias,
            self.linear2.weight.t(), self.linear2.bias,
            self.norm2.weight, self.norm2.bias, eps=1e-5,
        )


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MSDeformAttnPixelDecoder(nn.Module):
    """Per-level 1x1 proj + GN, deformable encoder layers, one FPN step
    to 1/4, and the mask-features 1x1 conv.

    forward(features) -> (mask_features, mask_features_before_conv,
    transformer_encoder_features, multi_scale_features), NHWC, the
    reference's forward_features contract (msdeformattn.py:316-360).
    """

    def __init__(self, in_channels: Dict[str, int], hidden_dim=256, mask_dim=256, num_layers=6,
                 num_heads=8, num_points=4, ffn_dim=1024,
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 fpn_in_features: Sequence[str] = ("res2",)):
        super().__init__()
        C = hidden_dim
        self.hidden_dim = C
        self.names_td = list(transformer_in_features)[::-1]  # coarse -> fine
        self.fpn_names = list(fpn_in_features)[::-1]
        self.num_layers = num_layers
        L = len(self.names_td)
        for i, name in enumerate(self.names_td):
            setattr(self, f"input_proj_{i}", nn.Conv2d(in_channels[name], C, 1))
            setattr(self, f"input_proj_gn_{i}", nn.GroupNorm(32, C, eps=1e-5))
        self.level_embed = nn.Parameter(torch.zeros(L, C))
        for li in range(num_layers):
            setattr(self, f"encoder_layer_{li}",
                    DeformableEncoderLayer(C, ffn_dim, L, num_heads, num_points))
        for i, name in enumerate(self.fpn_names):
            setattr(self, f"adapter_{i}", nn.Conv2d(in_channels[name], C, 1, bias=False))
            setattr(self, f"adapter_gn_{i}", nn.GroupNorm(32, C, eps=1e-5))
            setattr(self, f"layer_{i}", nn.Conv2d(C, C, 3, padding=1, bias=False))
            setattr(self, f"layer_gn_{i}", nn.GroupNorm(32, C, eps=1e-5))
        self.mask_features = nn.Conv2d(C, mask_dim, 1)
        self.pe = SinePositionEncoding3D(num_pos_feats=C // 2, normalize=True)

    def _tokens(self, features: Dict[str, torch.Tensor]):
        """Per-level 1x1 proj + GN, flattened coarse to fine: (src [N, S, C],
        pos [1, S, C] with the level embeds, spatial shapes)."""
        C = self.hidden_dim
        dtype = self.level_embed.dtype
        srcs, poss, shapes = [], [], []
        for i, name in enumerate(self.names_td):
            x = features[name]
            n, h, w, _ = x.shape
            y = getattr(self, f"input_proj_gn_{i}")(getattr(self, f"input_proj_{i}")(_nchw(x)))
            srcs.append(_nhwc(y).reshape(n, h * w, C))
            pos2d = self.pe.grid2d(h, w, device=x.device).to(dtype)
            poss.append(pos2d.reshape(1, h * w, C) + self.level_embed[i][None, None])
            shapes.append((h, w))
        return torch.cat(srcs, dim=1).contiguous(), torch.cat(poss, dim=1), tuple(shapes)

    def _outputs(self, src: torch.Tensor, spatial_shapes, features: Dict[str, torch.Tensor]):
        """Encoder tokens -> the four outputs of ``forward``: the levels as
        maps, the FPN step to 1/4 and the mask-features conv."""
        C = self.hidden_dim
        dtype = self.level_embed.dtype
        outs: List[torch.Tensor] = []
        start = 0
        n = src.shape[0]
        for (h, w) in spatial_shapes:
            outs.append(src[:, start:start + h * w].reshape(n, h, w, C))
            start += h * w

        for i, name in enumerate(self.fpn_names):
            x = features[name]
            lat = getattr(self, f"adapter_gn_{i}")(getattr(self, f"adapter_{i}")(_nchw(x)))
            up = F.interpolate(_nchw(outs[-1]), size=tuple(x.shape[1:3]), mode="bilinear",
                               align_corners=False).to(dtype)
            y = getattr(self, f"layer_gn_{i}")(getattr(self, f"layer_{i}")(lat + up))
            outs.append(_nhwc(F.relu(y)))

        mask_features_bfe_conv = outs[-1]
        mask_features = _nhwc(self.mask_features(_nchw(mask_features_bfe_conv)))
        return mask_features, mask_features_bfe_conv, outs[0], outs[:3]

    # the reference's training recomputes each encoder layer in the
    # backward (exact: a layer draws nothing), so that the plain sampling
    # law's float32 activations fit the card
    remat = False

    def forward(self, features: Dict[str, torch.Tensor]):
        src, pos, spatial_shapes = self._tokens(features)
        for li in range(self.num_layers):
            layer = getattr(self, f"encoder_layer_{li}")
            if self.remat and torch.is_grad_enabled():
                src = checkpoint(layer, src, pos, spatial_shapes, use_reentrant=False)
            else:
                src = layer(src, pos, spatial_shapes)
        return self._outputs(src, spatial_shapes, features)
