"""Target preparation for inference: dataset names and expressions ->
decoder prompt inputs (counterpart of
``univs_tpu/prompts/prepare_targets.py``): the dataset's slice of the
frozen category bank, all categories as detection prompts, and RefVOS
expressions as [sentence; 77 words] prompt stacks padded to a driver's
capacity."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from univs_tpu_torch.data.category_info import COMBINED_DATASETS_CATEGORY_INFO, dataset_namespace
from univs_tpu_torch.structures import TextPrompts


class PrepareTargets:
    def __init__(self, category_bank: np.ndarray, text_encoder=None):
        """category_bank: [3938, 640] frozen CLIP category embeddings;
        text_encoder: ``models.clip_text.TextPromptEncoder`` (RefVOS)."""
        self.bank = np.asarray(category_bank, np.float32)
        self.text_encoder = text_encoder

    def category_slice(self, dataset_name: str) -> np.ndarray:
        """The dataset's class-embedding bank slice."""
        k, start = COMBINED_DATASETS_CATEGORY_INFO[dataset_namespace(dataset_name)]
        return self.bank[start: start + k]

    def detection_inputs(self, dataset_name: str) -> Tuple[TextPrompts, torch.Tensor]:
        """Inference: all categories become prompt queries."""
        sl = torch.as_tensor(self.category_slice(dataset_name))
        tp = TextPrompts(embs=sl[None, :, None, :],
                         valid=torch.ones((1, sl.shape[0]), dtype=torch.bool))
        return tp, sl

    def grounding_inputs(self, expressions: Sequence[str], pad_to: Optional[int] = None) -> TextPrompts:
        """RefVOS: expressions -> [1, max(n, pad_to), 1+77, D] stacks of
        [sentence; words] on the text encoder's device, zero rows and
        ``valid`` False past the n expressions."""
        if self.text_encoder is None:
            raise ValueError("grounding needs the CLIP text tower (text_encoder)")
        word, sent = self.text_encoder.encode_expressions(list(expressions))
        n = word.shape[0]
        embs = torch.cat([sent[:, None], word], dim=1)  # [n, 1+77, D]
        if pad_to and pad_to > n:
            embs = F.pad(embs, (0, 0, 0, 0, 0, pad_to - n))
        valid = torch.arange(embs.shape[0], device=embs.device) < n
        return TextPrompts(embs=embs[None], valid=valid[None])
