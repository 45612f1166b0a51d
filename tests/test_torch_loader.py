"""The port's ``data/loader.py`` against the JAX package's: the collated
training batch array for array (the negative-category prompt padding
drawn from ``RandomState(int(ids.sum()) % 2**31)`` included), the
ratio-mixed loader's dataset choices and the shuffled, skip-on-empty
batching."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univs_tpu.data import loader as jl
from univs_tpu_torch.data import loader as tl

torch.set_num_threads(1)


def _samples(seed, B=3, T=2, N=4, H=16, W=24):
    rng = np.random.RandomState(seed)
    out = []
    for b in range(B):
        valid = rng.rand(N) > 0.3
        labels = np.where(valid, rng.randint(1, 9, N), 0).astype(np.int32)
        ids = np.where(valid[:, None], rng.randint(0, 50, (N, T)), -1).astype(np.int32)
        out.append(dict(images=(rng.rand(T, H, W, 3) * 255).astype(np.float32),
                        frame_indices=np.arange(T, dtype=np.int32) + b,
                        labels=labels, ids=ids, valid=valid,
                        masks=(rng.rand(N, T, H // 4, W // 4) > 0.5).astype(np.float32)))
    return out


def _flat(batch):
    t = batch.targets
    return {"images": batch.images, "frame_indices": batch.frame_indices, "labels": t.labels,
            "ids": t.ids, "masks": t.masks, "valid": t.valid, "prompt_obj_ids": t.prompt_obj_ids,
            "prompt_category_embs": batch.prompt_category_embs,
            "prompt_category_valid": batch.prompt_category_valid,
            "category_bank": batch.category_bank, "category_bank_valid": batch.category_bank_valid}


@pytest.mark.parametrize("seed,slots", [(0, 6), (1, 3), (2, 10)])
def test_collate_train_batch_matches_jax(seed, slots):
    samples = _samples(seed)
    bank = np.random.RandomState(seed + 100).randn(9, 16).astype(np.float32)
    bank_valid = np.ones(9, bool)
    want = _flat(jl.collate_train_batch(samples, bank, bank_valid, slots))
    got = _flat(tl.collate_train_batch(samples, bank, bank_valid, slots))
    assert set(want) == set(got)
    for k, v in want.items():
        g = got[k]
        assert isinstance(g, torch.Tensor), k
        np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=k)
        assert g.numpy().dtype == np.asarray(v).dtype, k
    assert int(jnp.sum(want["prompt_category_valid"])) > 0


def test_combined_loader_matches_jax():
    def loaders(mod):
        its = [iter(range(i * 1000, i * 1000 + 500)) for i in range(3)]
        return mod.CombinedLoader(its, [0.5, 0.3, 0.2], seed=7)

    a, b = loaders(jl), loaders(tl)
    assert [next(a) for _ in range(60)] == [next(b) for _ in range(60)]


@pytest.mark.parametrize("infinite", [False, True])
def test_dataset_iterator_matches_jax(infinite):
    records = [{"i": i} for i in range(7)]
    mapper = lambda r: None if r["i"] == 3 else r["i"]
    collate = lambda xs: tuple(xs)
    take = lambda it: [x for _, x in zip(range(6), it)]
    want = take(jl.dataset_iterator(records, mapper, 4, collate, seed=5, infinite=infinite))
    got = take(tl.dataset_iterator(records, mapper, 4, collate, seed=5, infinite=infinite))
    assert want == got and len(got) == (6 if infinite else 2)
