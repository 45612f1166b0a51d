"""Structured containers used across the port (torch dataclasses).

Counterpart of ``univs_tpu/structures.py``: the same fields and shapes,
as plain dataclasses of tensors instead of flax pytrees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

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


def make_visual_prompts(kv: torch.Tensor, kv_pe: Optional[torch.Tensor], kv_valid: torch.Tensor,
                        valid: torch.Tensor,
                        use_pe_as_query_pos: Union[bool, torch.Tensor] = True,
                        t: Optional[int] = None) -> VisualPrompts:
    """Query initialisations from kv sets, the reference's non-blank means
    (decoder_univs.py:640-650): queries = mean of the valid kv features,
    query_pos = mean of the valid kv PE, or (a training coin flip,
    ``use_pe_as_query_pos`` False) the feature mean.  A singleton frame
    axis is broadcast to ``t`` for the queries only."""
    denom = kv_valid.sum(dim=2)[..., None].clamp(min=1)  # [B, Qp, T, 1]
    m = kv_valid[..., None].to(kv.dtype)
    feats_mean = (kv * m).sum(dim=2) / denom
    pe_mean = feats_mean if kv_pe is None else (kv_pe * m).sum(dim=2) / denom
    if isinstance(use_pe_as_query_pos, bool):
        qpos = pe_mean if use_pe_as_query_pos else feats_mean
    else:
        qpos = torch.where(use_pe_as_query_pos, pe_mean, feats_mean)
    if t is not None and feats_mean.shape[2] == 1 and t > 1:
        B, Qp, _, C = feats_mean.shape
        feats_mean = feats_mean.expand(B, Qp, t, C)
        qpos = qpos.expand(B, Qp, t, C)
    return VisualPrompts(queries=feats_mean, query_pos=qpos, kv=kv, kv_pe=kv_pe,
                         kv_valid=kv_valid, valid=valid)


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
