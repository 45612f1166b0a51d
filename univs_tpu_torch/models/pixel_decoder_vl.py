"""Vision-language pixel decoder: the deformable encoder with a
bi-directional vision<->language fusion before each layer (counterpart
of ``univs_tpu/models/pixel_decoder_vl.py``), NHWC at the module
boundary.

``VLFuse`` is GLIP's pre-LN bi-attention with layer-scale gammas: one
(Sv x Sl) logits matrix per head, softmaxed over the language axis for
vision and over the vision axis for language.  The laws are the JAX
module's:

- the logits are clamped to +-50,000, and the lang->vision softmax runs
  over the vision axis on max-normalised, clamped logits;
- ``lang_valid`` masks only the vision->lang softmax, with -9e15;
- the residual base is the *normed* feature (the reference reassigns
  v / l to their LayerNorms before adding the scaled deltas);
- the LayerNorms run in float32 and the gammas are held in float32,
  cast to the feature's dtype where they scale it;
- VLFuse's ``embed_dim`` is the encoder's ``ffn_dim`` (1024), not GLIP's
  512.

The deformable encoder layers are ``pixel_decoder.DeformableEncoderLayer``
(the decoder subclasses ``MSDeformAttnPixelDecoder``),
so kernels B, A and C run in them on CUDA tensors.  Outputs:
(mask_features, mask_features_before_conv, transformer_encoder_features,
multi_scale_features, lang_features).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from univs_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from univs_tpu_torch.models.transformer_layers import LayerNorm32


class BiMultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, v_dim: int, l_dim: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)

    def forward(self, v: torch.Tensor, l: torch.Tensor, lang_valid: Optional[torch.Tensor] = None):
        """v: [B, Sv, Cv], l: [B, Sl, Cl], lang_valid [B or 1, Sl] bool ->
        (dv [B, Sv, Cv], dl [B, Sl, Cl])."""
        H = self.num_heads
        hd = self.embed_dim // H

        def proj(x, layer):  # -> [B, H, S, hd]
            y = layer(x)
            return y.reshape(*y.shape[:-1], H, hd).transpose(1, 2)

        q = proj(v, self.v_proj) * hd ** -0.5
        k = proj(l, self.l_proj)
        vv = proj(v, self.values_v_proj)
        vl = proj(l, self.values_l_proj)

        logits = (q @ k.transpose(-1, -2)).to(torch.float32).clamp_(-50000.0, 50000.0)  # [B,H,Sv,Sl]
        lt = (logits - logits.amax(dim=2, keepdim=True)).clamp_(-50000.0, 50000.0)
        attn_l = torch.softmax(lt, dim=2)
        del lt
        if lang_valid is not None:
            logits = logits.masked_fill(~lang_valid.to(torch.bool)[:, None, None, :], -9e15)
        attn_v = torch.softmax(logits, dim=3)
        del logits
        dv = (attn_v.to(vl.dtype) @ vl).transpose(1, 2)  # [B, Sv, H, hd]
        dl = (attn_l.to(vv.dtype).transpose(-1, -2) @ vv).transpose(1, 2)  # [B, Sl, H, hd]
        dv = self.out_v_proj(dv.reshape(*dv.shape[:-2], self.embed_dim))
        dl = self.out_l_proj(dl.reshape(*dl.shape[:-2], self.embed_dim))
        return dv, dl


class VLFuse(nn.Module):
    """Pre-LN bi-attention with layer-scale gammas (GLIP VLFuse)."""

    keep_float32 = ("gamma_v", "gamma_l")

    def __init__(self, v_dim: int = 256, l_dim: int = 640, embed_dim: int = 512, num_heads: int = 8):
        super().__init__()
        self.layer_norm_v = LayerNorm32(v_dim, eps=1e-5)
        self.layer_norm_l = LayerNorm32(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(embed_dim, num_heads, v_dim, l_dim)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), 1 / 6))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), 1 / 6))

    def forward(self, v, l, lang_valid=None):
        vn, ln = self.layer_norm_v(v), self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, lang_valid)
        return vn + self.gamma_v.to(v.dtype) * dv, ln + self.gamma_l.to(l.dtype) * dl


class MSDeformAttnPixelDecoderVL(MSDeformAttnPixelDecoder):
    """``MSDeformAttnPixelDecoder`` with ``vl_fuse_{i}`` before each
    ``encoder_layer_{i}``.

    forward(features, lang_feats [B or 1, Sl, lang_dim], lang_valid
    [B or 1, Sl] bool or None) -> (mask_features, mask_features_bfe_conv,
    enc_feat, multi_scale_features, lang_features), the reference's VL
    forward contract (msdeformattn_vl.py:331-374); the language features
    come back broadcast to the frame batch."""

    def __init__(self, in_channels: Dict[str, int], hidden_dim=256, mask_dim=256, num_layers=6,
                 num_heads=8, num_points=4, ffn_dim=1024, lang_dim=640,
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 fpn_in_features: Sequence[str] = ("res2",)):
        super().__init__(in_channels, hidden_dim, mask_dim, num_layers, num_heads, num_points,
                         ffn_dim, transformer_in_features, fpn_in_features)
        for li in range(num_layers):
            setattr(self, f"vl_fuse_{li}", VLFuse(v_dim=hidden_dim, l_dim=lang_dim,
                                                  embed_dim=ffn_dim))

    def forward(self, features: Dict[str, torch.Tensor], lang_feats: torch.Tensor,
                lang_valid: Optional[torch.Tensor] = None):
        src, pos, spatial_shapes = self._tokens(features)
        lang = lang_feats.to(src.dtype)
        if lang.shape[0] != src.shape[0]:
            lang = lang.expand(src.shape[0], *lang.shape[1:])
        for li in range(self.num_layers):
            src, lang = getattr(self, f"vl_fuse_{li}")(src, lang, lang_valid)
            src = getattr(self, f"encoder_layer_{li}")(src, pos, spatial_shapes)
        return (*self._outputs(src, spatial_shapes, features), lang)
