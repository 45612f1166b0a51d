"""CLIP text encoder (RN50x4 geometry), counterpart of
``univs_tpu/models/clip_text.py``.

The frozen language tower (12-layer causal transformer, width 640, 10
heads, context 77, vocab 49,408, embed 640 for the RN50x4 checkpoint)
and ``TextPromptEncoder``, which turns RefVOS expressions into 77 word
features from the bare ``'{}.'`` template and a sentence feature, the
EOT feature averaged over the 81 templates, and class names into a
mean-EOT category bank.

Module names follow the flax tree (``block_{i}/{ln_1, attn, ln_2, c_fc,
c_proj}``, ``ln_final``, the raw ``token_embedding``,
``positional_embedding`` and ``text_projection`` parameters), so the
weight bridge maps a flax tree one to one.  The tower runs in float32
whatever the model's compute dtype is, as the JAX package's does: it is
not part of ``UniVSModel``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from univs_tpu_torch.models.tokenizer import (
    CONTEXT_LENGTH,
    VOCAB_SIZE,
    ClipTokenizer,
    clean_category_string,
    pre_tokenize,
)
from univs_tpu_torch.models.transformer_layers import MultiHeadAttention
from univs_tpu_torch.utils.device import resolve_device


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ClipResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.c_fc = nn.Linear(width, width * 4)
        self.gelu = QuickGELU()
        self.c_proj = nn.Linear(width * 4, width)

    def forward(self, x, causal_bias):
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, causal_bias)
        return x + self.c_proj(self.gelu(self.c_fc(self.ln_2(x))))


class ClipTextEncoder(nn.Module):
    def __init__(self, embed_dim: int = 640, context_length: int = CONTEXT_LENGTH,
                 vocab_size: int = VOCAB_SIZE, width: int = 640, heads: int = 10,
                 num_layers: int = 12):
        super().__init__()
        self.width = width
        self.num_layers = num_layers
        self.token_embedding = nn.Parameter(torch.zeros(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        for i in range(num_layers):
            setattr(self, f"block_{i}", ClipResidualBlock(width, heads))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [N, L] int -> (word_feats [N, L, D], eot_feats [N, D]);
        the EOT feature is the word feature at the largest token id."""
        L = tokens.shape[-1]
        x = self.token_embedding[tokens] + self.positional_embedding[None, :L]
        upper = torch.ones((L, L), dtype=torch.bool, device=tokens.device).triu(1)
        causal = torch.where(upper, -1e9, 0.0).to(torch.float32)[None, None]
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, causal)
        word = self.ln_final(x) @ self.text_projection
        eot_idx = torch.argmax(tokens, dim=-1)
        eot = torch.take_along_dim(word, eot_idx[:, None, None], dim=1)[:, 0]
        return word, eot


class TextPromptEncoder:
    """Expressions / class names -> CLIP features on ``device`` (the card
    unless "cpu"), in float32.

    ``params``: the tower's state_dict (e.g. from
    ``utils.weights.state_dict_from_flax``), loaded strictly into
    ``encoder``, or None for the port's seeded init of ``encoder``
    (``seed``).  ``encoder`` gives the tower's geometry (RN50x4 when
    None); its parameters are always overwritten, so a module built
    but never initialised cannot reach the encode with its zeros."""

    def __init__(self, params=None, encoder: Optional[ClipTextEncoder] = None,
                 tokenizer: Optional[ClipTokenizer] = None, device=None, seed: int = 0):
        from univs_tpu_torch.utils import weights

        if isinstance(params, nn.Module):
            raise TypeError("params is the tower's state_dict or None; pass the module "
                            "as encoder=")
        self.device = resolve_device(device)
        encoder = encoder or ClipTextEncoder()
        if params is None:
            weights.init_params(encoder, seed)
        else:
            weights.load_state_dict_strict(encoder, params)
        self.encoder = encoder.to(device=self.device, dtype=torch.float32).eval()
        self.encoder.requires_grad_(False)
        self.tokenizer = tokenizer or ClipTokenizer()

    @torch.no_grad()
    def encode_tokens(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """[n, m, L] token ids (``pre_tokenize``) -> (word [n, m, L, D],
        eot [n, m, D])."""
        n, m, L = tokens.shape
        t = torch.as_tensor(tokens, dtype=torch.int64, device=self.device).reshape(n * m, L)
        word, eot = self.encoder(t)
        return word.reshape(n, m, L, -1), eot.reshape(n, m, -1)

    def encode_expressions(self, expressions) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (word_feats [N, 77, D] from template '{}.', sentence_feats
        [N, D] mean-EOT over the 81 templates)."""
        tokens = pre_tokenize(list(expressions), self.tokenizer, text_type="expression")
        word, eot = self.encode_tokens(tokens)
        return word[:, 0], eot.mean(dim=1)

    def encode_category_names(self, names, clean: bool = True) -> torch.Tensor:
        """-> [K, D] mean-EOT category bank (clean_strings on the full
        synonym row, 81 templates, EOT mean)."""
        names = list(names)
        if clean:
            names = [clean_category_string(n) for n in names]
        _, eot = self.encode_tokens(pre_tokenize(names, self.tokenizer, text_type="class_name"))
        return eot.mean(dim=1)
