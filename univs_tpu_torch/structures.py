"""Structured containers used across the port (torch dataclasses).

Counterpart of ``univs_tpu/structures.py``: the same fields and shapes,
as plain dataclasses of tensors instead of flax pytrees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class VisualPrompts:
    """Per-target visual prompt feature sets consumed by ProCA.

    Shapes: B videos, Qp prompt slots, L prompt tokens per target, T
    frames, C hidden.  ``kv`` may carry a SINGLETON frame axis
    ([B, Qp, L, 1, C]) when one prompt set is shared by every clip frame
    (the memory-pool read); the decoder's ProCA then folds frames into
    the query axis instead of materializing the T-fold broadcast.
    """

    queries: torch.Tensor  # [B, Qp, T, C]
    query_pos: torch.Tensor  # [B, Qp, T, C]
    kv: torch.Tensor  # [B, Qp, L, T|1, C]
    kv_pe: Optional[torch.Tensor]  # [B, Qp, L, T|1, C] or None
    kv_valid: torch.Tensor  # [B, Qp, L, T|1] bool
    valid: torch.Tensor  # [B, Qp] bool

    @property
    def num_prompts(self) -> int:
        return self.queries.shape[1]


@dataclass
class TextPrompts:
    """CLIP-text prompt inputs (detection: [B, Kp, 1, Dt] category
    embeddings; grounding: [B, Qp, 1+77, Dt] expression stacks)."""

    embs: torch.Tensor
    valid: torch.Tensor  # [B, Qp] bool
    word_valid: Optional[torch.Tensor] = None  # [B, Qp, L] bool


@dataclass
class DecoderOutputs:
    """One prediction set (final or auxiliary)."""

    logits: torch.Tensor  # [B, Q, K]
    masks: torch.Tensor  # [B, Q, T, H, W] mask logits (1/4 res)
    embds: torch.Tensor  # [B, Q, T, C] decoder-normed query embeddings
    embds_raw: torch.Tensor  # [B, Q, T, C] pre-norm
