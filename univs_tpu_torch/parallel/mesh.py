"""The ("data", "model") layout of the training processes (counterpart of
``univs_tpu/parallel/mesh.py``).

JAX lays its devices out as ``reshape(n // m, m)`` under the axes
("data", "model"): consecutive devices form one model group.  Here a
process takes the device's place: rank r of a world of n sits at data
index r // m and model index r % m.  The ranks of one data index form a
*frame group*: they hold the same videos and split each clip's frames
between them (JAX's ``frame_sharding``: the batch over "data", the frames
over "model").  The ranks of one model index form a *data group*, over
which the global batch is sharded (``parallel/ddp.py``'s ``BatchShard``).

The backbone and the pixel decoder are per-frame, so each rank of a frame
group encodes its ``frame_slice`` of the clip, and ``gather_frames`` puts
the whole clip's features together where the UniVS decoder couples the
frames; every rank of the group then runs the decoder and the criterion on
the same videos with the same draws.  The train step
(``parallel/train_state.make_train_step(..., mesh=)``) reduces the
gradients accordingly: a rank's share of the encoder's gradients (its
frames) is summed over the world, and the gradients a frame group holds
one copy of per rank enter the world's sum at 1 / m each.  When T does not
divide by m, every rank encodes the whole clip (JAX's fallback) and every
gradient is such a copy.

The data axis alone and ``init_multihost`` are ``parallel/ddp.py``'s
(``init_distributed`` / ``init_from_env``, and ``shard_batch`` for
``batch_sharding``: a rank takes ``shard_batch(batch, mesh.data_rank,
mesh.data_size)``); ``init_distributed`` is re-exported here under JAX's
name, ``init_multihost``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from univs_tpu_torch.parallel.ddp import init_distributed as init_multihost  # noqa: F401

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, model) layout: its index and the
    axis's size on each axis, the process group of its data index's ranks
    (``frame_group``) and of its model index's ranks (``data_group``), and
    the group the layout spans (``group``).  The groups are None in a
    world of one process; ``data_mesh``'s has no frame group."""

    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    data_group: Any = None
    frame_group: Any = None
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None


def mesh_layout(world: int, model_parallel: int = 1) -> np.ndarray:
    """The ranks of a world of ``world`` as a [world // m, m] array: row i
    holds data index i's frame group, column j model index j's data group
    (JAX's ``reshape(n // m, m)``).  Refuses a world m does not divide."""
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"a world of {world} does not split into model groups of "
                         f"{model_parallel}")
    return np.arange(world).reshape(world // model_parallel, model_parallel)


def make_mesh(model_parallel: int = 1) -> Mesh:
    """This process's ``Mesh`` over the default process group (a world of
    one when no process group exists).  Every process must call it, in the
    same order as its other group creations: each creates every data and
    frame group with ``dist.new_group``."""
    if not dist.is_initialized():
        mesh_layout(1, model_parallel)
        return Mesh(0, 1, 0, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    layout = mesh_layout(world, model_parallel)
    data_index, model_index = divmod(rank, model_parallel)
    data_group = frame_group = None
    for j in range(layout.shape[1]):
        g = dist.new_group(layout[:, j].tolist())
        if j == model_index:
            data_group = g
    for i in range(layout.shape[0]):
        g = dist.new_group(layout[i].tolist())
        if i == data_index:
            frame_group = g
    return Mesh(data_index, layout.shape[0], model_index, model_parallel, data_group,
                frame_group, dist.group.WORLD)


def data_mesh(group=None) -> Mesh:
    """The data axis alone over ``group`` (None: the default group): the
    data-parallel step's layout, a model axis of 1 that creates no group."""
    if group is None and not dist.is_initialized():
        return Mesh(0, 1, 0, 1)
    group = dist.group.WORLD if group is None else group
    return Mesh(dist.get_rank(group), dist.get_world_size(group), 0, 1, data_group=group,
                group=group)


def frame_slice(t: int, mesh: Optional[Mesh]) -> slice:
    """This rank's contiguous frames of a clip of ``t`` (the counterpart of
    ``frame_sharding``): the whole clip without a mesh, with a model axis
    of 1, or when ``t`` does not divide by it (JAX's fallback,
    ``univs_tpu/parallel/train_state.py:291``)."""
    if mesh is None or mesh.model_size == 1 or t % mesh.model_size:
        return slice(0, t)
    n = t // mesh.model_size
    return slice(mesh.model_rank * n, (mesh.model_rank + 1) * n)


def splits_frames(t: int, mesh: Optional[Mesh]) -> bool:
    """Whether ``frame_slice`` gives this rank less than the clip."""
    s = frame_slice(t, mesh)
    return s.stop - s.start < t


class _GatherFrames(torch.autograd.Function):
    """[b * t/m, ...] features of this rank's frames -> the clip's
    [b * t, ...] on every rank of the frame group (b-major); the backward
    returns this rank's slice of the gradient, unsummed: every rank of the
    group computes the same loss on the gathered clip, so the gradient a
    rank receives is already the whole gradient of one copy of it."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, b: int, t: int):
        s = frame_slice(t, mesh)
        ctx.frames, ctx.b, ctx.t = s, b, t
        # a zero buffer of the clip with this rank's frames in place, summed
        # over the group: an all-gather gloo can also run on CUDA tensors
        buf = x.new_zeros((b, t, *x.shape[1:]))
        buf[:, s] = x.reshape(b, s.stop - s.start, *x.shape[1:])
        dist.all_reduce(buf, group=mesh.frame_group)
        return buf.reshape(b * t, *x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        s, b, t = ctx.frames, ctx.b, ctx.t
        g = grad.reshape(b, t, *grad.shape[1:])[:, s]
        return g.reshape(b * (s.stop - s.start), *grad.shape[1:]), None, None, None


def gather_frames(x: torch.Tensor, mesh: Mesh, b: int, t: int) -> torch.Tensor:
    """The whole clip's features from each rank's ``frame_slice``: ``x``
    [b * t/m, ...] in b-major order, as ``encode_features`` flattens it;
    with autograd (the backward is this rank's slice, unsummed)."""
    return _GatherFrames.apply(x, mesh, b, t)
