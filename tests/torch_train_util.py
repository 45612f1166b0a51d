"""Shared pieces of the training-path parity tests (the port against the
JAX package): a draw source that replays JAX keys for the port's
``DrawKey``s, seeded flax params without running the flax init, and
the tiny training batch built identically for both packages."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core.scope import LazyRng

from univs_tpu.config import TrainConfig, tiny_test_config
from univs_tpu_torch.config import TrainConfig as TTrainConfig
from univs_tpu_torch.config import tiny_test_config as torch_tiny_config
from univs_tpu_torch.utils.draws import DrawKey


class JaxSource:
    """Draws of a ``DrawKey`` path from the JAX key it addresses."""

    def __init__(self, root):
        self.root = root

    def key(self, path):
        k = self.root
        for op in path:
            if op[0] == "fold":
                k = jax.random.fold_in(k, op[1])
            elif op[0] == "split":
                k = jax.random.split(k, op[1])[op[2]]
            else:
                k = LazyRng.create(k, *op[1]).as_jax_rng()
        return k

    def uniform(self, path, shape, minval, maxval):
        return torch.as_tensor(np.array(jax.random.uniform(self.key(path), shape, jnp.float32,
                                                             minval, maxval)))

    def randint(self, path, low, high):
        return int(jax.random.randint(self.key(path), (), low, high))

    def gumbel(self, path, shape):
        return torch.as_tensor(np.array(jax.random.gumbel(self.key(path), shape)))

    def permutation(self, path, n):
        return torch.as_tensor(np.array(jax.random.permutation(self.key(path), n)),
                               dtype=torch.int64)


def jax_key(seed: int):
    """(the JAX key, the port's DrawKey replaying it)."""
    k = jax.random.PRNGKey(seed)
    return k, DrawKey(JaxSource(k))


def train_cfgs(num_points: int = 32, decoder_layers: int = 1, encoder_layers: int = 1):
    """The tiny config for training in both packages, with the depth-10
    ResNet trunk (R50's strides and channels, one bottleneck a stage) and
    fewer decoder and encoder layers: the JAX train step's compile grows
    with each layer."""
    out = []
    for base, tc in ((tiny_test_config(), TrainConfig), (torch_tiny_config(), TTrainConfig)):
        out.append(base.replace(
            train=tc(num_points=num_points, oversample_ratio=2.0),
            backbone=dataclasses.replace(base.backbone, resnet_depth=10),
            decoder=dataclasses.replace(base.decoder, num_layers=decoder_layers),
            pixel_decoder=dataclasses.replace(base.pixel_decoder, num_layers=encoder_layers)))
    return out


def seeded_flax_params(init_fn, seed: int):
    """A param tree of ``init_fn``'s structure (traced, not run) filled
    with seeded values of the usual scales: kernels N(0, 1/fan_in),
    biases N(0, 0.1), norm scales 1 + N(0, 0.1), BN variances in [1, 1.5),
    the logit temperatures log(1/0.07), everything else N(0, 1)."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = leaf.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            v = rng.randn(*shape) * 0.1
        elif name == "scale":
            v = 1.0 + rng.randn(*shape) * 0.1
        elif name == "var":
            v = 1.0 + rng.rand(*shape) * 0.5
        elif name in ("cls_temp", "reid_temp"):
            v = np.full(shape, np.log(1 / 0.07))
        elif name.startswith("prompt_"):
            v = rng.randn(*shape) * 0.02
        else:
            v = rng.randn(*shape)
        return jnp.asarray(v, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_train_arrays(cfg, seed: int = 0, B: int = 2, T: int = 2, H: int = 64, W: int = 64,
                      N: int = 3, K: int = 4, L: int = 8):
    """numpy arrays of one training batch: images, frame indices, a class
    bank, targets (labels, ids with an absent frame, masks at 1/4,
    validity with one padded slot), detection prompts (targets then one
    negative category), grounding expressions."""
    rng = np.random.RandomState(seed)
    Dt = cfg.decoder.clip_cls_emb_dim
    images = (rng.rand(B, T, H, W, 3) * 255).astype(np.float32)
    fi = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    bank = rng.randn(K, Dt).astype(np.float32)
    labels = rng.randint(1, K + 1, (B, N)).astype(np.int32)
    valid = np.ones((B, N), bool)
    valid[1, -1] = False
    labels[~valid] = 0
    ids = np.broadcast_to(np.arange(N)[None, :, None], (B, N, T)).astype(np.int32).copy()
    ids[0, 1, 1] = -1
    masks = (rng.rand(B, N, T, H // 4, W // 4) > 0.7).astype(np.float32)
    masks[0, 1, 1] = 0.0
    masks[~valid] = 0.0
    Qp = N + 1
    poi = np.full((B, Qp), -1, np.int32)
    pemb = np.zeros((B, Qp, Dt), np.float32)
    for b in range(B):
        for n in range(N):
            if valid[b, n]:
                poi[b, n] = n
                pemb[b, n] = bank[labels[b, n] - 1]
        pemb[b, N] = bank[(b + 1) % K]
    exp_embs = rng.randn(B, N, L, Dt).astype(np.float32)
    return dict(images=images, frame_indices=fi, bank=bank, labels=labels, ids=ids, masks=masks,
                valid=valid, poi=poi, prompt_embs=pemb, prompt_valid=np.ones((B, Qp), bool),
                exp_embs=exp_embs, exp_valid=valid.copy())


def jax_batch(a, task: str):
    """The JAX ``TrainBatch`` of ``tiny_train_arrays`` for ``task``."""
    from univs_tpu.losses.criterion import TrainTargets
    from univs_tpu.parallel.train_state import TrainBatch

    j = jnp.asarray
    poi = a["poi"] if task == "detection" else np.where(a["valid"], np.arange(a["valid"].shape[1])[None], -1)
    tg = TrainTargets(labels=j(a["labels"]), ids=j(a["ids"]), masks=j(a["masks"]),
                      valid=j(a["valid"]), prompt_obj_ids=j(poi.astype(np.int32)))
    kw = {}
    if task == "detection":
        kw = dict(prompt_category_embs=j(a["prompt_embs"]),
                  prompt_category_valid=j(a["prompt_valid"]), category_bank=j(a["bank"]),
                  category_bank_valid=jnp.ones((a["bank"].shape[0],), bool))
    elif task == "grounding":
        kw = dict(exp_embs=j(a["exp_embs"]), exp_valid=j(a["exp_valid"]))
    return TrainBatch(images=j(a["images"]), frame_indices=j(a["frame_indices"]), targets=tg, **kw)


def torch_batch(a, task: str):
    """The port's ``TrainBatch`` of the same arrays."""
    from univs_tpu_torch.losses.criterion import TrainTargets
    from univs_tpu_torch.parallel.train_state import TrainBatch

    t = torch.as_tensor
    poi = a["poi"] if task == "detection" else np.where(a["valid"], np.arange(a["valid"].shape[1])[None], -1)
    tg = TrainTargets(labels=t(a["labels"]).long(), ids=t(a["ids"]).long(), masks=t(a["masks"]),
                      valid=t(a["valid"]), prompt_obj_ids=t(poi).long())
    kw = {}
    if task == "detection":
        kw = dict(prompt_category_embs=t(a["prompt_embs"]), prompt_category_valid=t(a["prompt_valid"]),
                  category_bank=t(a["bank"]),
                  category_bank_valid=torch.ones(a["bank"].shape[0], dtype=torch.bool))
    elif task == "grounding":
        kw = dict(exp_embs=t(a["exp_embs"]), exp_valid=t(a["exp_valid"]))
    return TrainBatch(images=t(a["images"]), frame_indices=t(a["frame_indices"]).long(), targets=tg, **kw)


def zero_gradient_in_law(name: str, cfg) -> bool:
    """A parameter whose gradient is 0 in exact arithmetic: the bias of a
    pixel-decoder input projection feeding a GroupNorm of one channel a
    group (32 groups of a 32-wide tiny config), which the norm subtracts.
    Its computed gradient is rounding noise, which Adam's normalisation
    turns into a move of up to a good part of a step in each package
    alike, in directions that need not agree; such a tensor is held by
    the group-level change norms, not element-wise."""
    import re

    return (cfg.pixel_decoder.hidden_dim == 32
            and re.fullmatch(r"pixel_decoder\.input_proj_\d+\.bias", name) is not None)
