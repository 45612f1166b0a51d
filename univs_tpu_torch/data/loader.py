"""Batch building and multi-dataset mixing (counterpart of
``univs_tpu/data/loader.py``; numpy only until the batch is made).

``collate_train_batch`` stacks mapper outputs into a ``TrainBatch`` of
CPU tensors: the detection prompt slots are the targets' category
embeddings, then negative categories drawn from
``RandomState(int(ids.sum()) % 2**31)`` (reference:
prepare_targets.py:324-385).  ``CombinedLoader`` samples whole batches
from one dataset at a time by ratio (reference: combined_loader.py),
``dataset_iterator`` shuffles, skips empty samples and batches.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np
import torch

from univs_tpu_torch.losses.criterion import TrainTargets
from univs_tpu_torch.parallel.train_state import TrainBatch


def collate_train_batch(samples: List[Dict], category_bank: np.ndarray,
                        category_valid: np.ndarray, prompt_slots: int) -> TrainBatch:
    """Mapper outputs (dicts of numpy arrays: images, frame_indices,
    labels, ids, masks, valid) -> a ``TrainBatch`` with the detection
    prompt slots filled."""
    images = np.stack([s["images"] for s in samples])
    fi = np.stack([s["frame_indices"] for s in samples])
    labels = np.stack([s["labels"] for s in samples])
    ids = np.stack([s["ids"] for s in samples])
    masks = np.stack([s["masks"] for s in samples])
    valid = np.stack([s["valid"] for s in samples])

    B, N = labels.shape
    Qp = prompt_slots
    rng = np.random.RandomState(int(ids.sum()) % (2 ** 31))
    prompt_embs = np.zeros((B, Qp, category_bank.shape[-1]), np.float32)
    prompt_valid = np.zeros((B, Qp), bool)
    prompt_obj_ids = np.full((B, Qp), -1, np.int32)
    K = category_bank.shape[0]
    for b in range(B):
        pos = np.nonzero(valid[b])[0][:Qp]
        for q, n in enumerate(pos):
            prompt_embs[b, q] = category_bank[labels[b, n] - 1]
            prompt_obj_ids[b, q] = n
            prompt_valid[b, q] = True
        neg = rng.permutation(K)[: Qp - len(pos)]
        for q, c in enumerate(neg, start=len(pos)):
            prompt_embs[b, q] = category_bank[c]
            prompt_valid[b, q] = True

    t = torch.as_tensor
    targets = TrainTargets(labels=t(labels), ids=t(ids), masks=t(masks), valid=t(valid),
                           prompt_obj_ids=t(prompt_obj_ids))
    return TrainBatch(images=t(images), frame_indices=t(fi), targets=targets,
                      prompt_category_embs=t(prompt_embs), prompt_category_valid=t(prompt_valid),
                      category_bank=t(np.asarray(category_bank)),
                      category_bank_valid=t(np.asarray(category_valid)))


class CombinedLoader:
    """Whole batches from one dataset at a time, chosen by ratio
    (reference: combined_loader.py CombinedDataLoader_Mix)."""

    def __init__(self, loaders: Sequence[Iterator], ratios: Sequence[float], seed: int = 0):
        assert len(loaders) == len(ratios)
        self.loaders = list(loaders)
        p = np.asarray(ratios, np.float64)
        self.p = p / p.sum()
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        return self

    def __next__(self):
        i = self.rng.choice(len(self.loaders), p=self.p)
        return next(self.loaders[i])


def dataset_iterator(records: List[Dict], mapper: Callable, batch_size: int,
                     collate: Callable, seed: int = 0, infinite: bool = True):
    """Shuffled, skip-on-empty iterator over mapped records; a partial
    batch carries over epochs, and ends the last epoch when not infinite."""
    rng = np.random.RandomState(seed)
    batch = []
    while True:
        order = rng.permutation(len(records))
        for i in order:
            s = mapper(records[i])
            if s is None:
                continue
            batch.append(s)
            if len(batch) == batch_size:
                yield collate(batch)
                batch = []
        if not infinite:
            if batch:
                yield collate(batch)
            return
