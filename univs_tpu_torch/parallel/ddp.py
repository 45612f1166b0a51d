"""Data parallelism over processes, one a card (in place of
``univs_tpu/parallel/mesh.py``'s data axis; the reference trains with DDP
over NCCL).

The law held is the JAX package's global-batch step, not the
reference's per-rank losses: the loss is that of the whole global batch
and the gradient its gradient.  Three things make that more than wrapping
the model in ``DistributedDataParallel``:

* the criterion couples the videos.  Every batch reduction of a count
  (the mask normalisers, the per-video class weights, the contrastive
  caps and normalisers, the semantic and lang->vision keeps, BoxVIS's
  confident-target count, the long-video mean over videos) becomes a
  global count, the ``all_reduce`` of a detached count
  (``BatchShard.count``), so each rank's sum over its own videos divided
  by the global count adds up, over the ranks, to the one-process loss.
  The contrastive losses take other videos' rows as negatives: each rank
  scores its own rows against the columns of every rank
  (``BatchShard.columns``, a gather with autograd whose backward sends
  each column's gradient to the rank that owns it), and every rank makes
  the same global column pick;
* the gradients are summed (float32, one flat buffer per label group)
  after ``backward()`` and before the group's global-norm clip, so the
  clip sees the global gradient as JAX's psum does (the DDP wrapper
  would average the compute-dtype working gradients instead);
* each rank takes its slice of the global batch's draws at JAX's
  addresses (``BatchShard.split`` / ``BatchShard.rows``), never draws of
  its own.

Gloo reduces CUDA tensors with ``all_reduce`` and ``broadcast`` only, so
every collective here is an ``all_reduce``: the same code runs on gloo
(the CPU, or several processes on one card) and on NCCL.

JAX's ``model`` axis (``frame_sharding``: a clip's frames split over a
group of ranks) is ``parallel/mesh.py``'s: ``make_mesh(model_parallel)``
and ``make_train_step(..., mesh=)``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

# the fields of a TrainBatch every rank holds whole (the class bank)
SHARED_FIELDS = ("category_bank", "category_bank_valid")


class _GatherRows(torch.autograd.Function):
    """Each rank's row block placed at its offset in a zero buffer of the
    global rows, summed over the ranks; the backward sums the gradient
    over the ranks and returns this rank's slice."""

    @staticmethod
    def forward(ctx, x, start: int, total: int, group):
        ctx.start, ctx.n, ctx.group = start, x.shape[0], group
        buf = x.new_zeros((total, *x.shape[1:]))
        buf[start:start + x.shape[0]] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.start:ctx.start + ctx.n], None, None, None


@dataclass(frozen=True)
class BatchShard:
    """This process's videos of the global batch: ``offset`` the first,
    ``local`` how many, ``total`` the global count.  ``distributed``
    False (``whole``): one process holds the batch and every method is
    the identity."""

    offset: int
    local: int
    total: int
    distributed: bool = False
    group: Any = None

    @staticmethod
    def whole(b: int) -> "BatchShard":
        return BatchShard(0, b, b)

    @staticmethod
    def of(local: int, group=None, device=None) -> "BatchShard":
        """The shard of a rank holding ``local`` videos: every rank's count
        from one ``all_reduce``, the offset their sum over lower ranks."""
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        sizes = torch.zeros(world, dtype=torch.int64, device=device)
        sizes[rank] = local
        dist.all_reduce(sizes, group=group)
        sizes = sizes.tolist()
        return BatchShard(sum(sizes[:rank]), local, sum(sizes), True, group)

    def count(self, x: torch.Tensor) -> torch.Tensor:
        """The global sum of a count (no gradient)."""
        if not self.distributed:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def split(self, key):
        """This rank's keys of a per-video ``split(total)``."""
        return key.split(self.total)[self.offset:self.offset + self.local]

    def rows_total(self, rows: int) -> int:
        """Global row count of a per-video row-major axis of ``rows`` local rows."""
        return rows // self.local * self.total

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global draw whose leading axis is row-major
        over the videos."""
        per = x.shape[0] // self.total
        return x[self.offset * per:(self.offset + self.local) * per]

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (leading axis row-major over this
        rank's videos), in global order; with autograd for floating
        tensors."""
        if not self.distributed:
            return x
        per = x.shape[0] // self.local
        start, total = self.offset * per, self.total * per
        if x.is_floating_point():
            return _GatherRows.apply(x, start, total, self.group)
        wide = x.to(torch.int64)
        buf = wide.new_zeros((total, *x.shape[1:]))
        buf[start:start + x.shape[0]] = wide
        dist.all_reduce(buf, group=self.group)
        return buf.to(x.dtype)


def init_distributed(backend: str = "nccl", init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     device: Optional[torch.device] = None):
    """Join the process group (the counterpart of ``init_multihost``):
    ``init_method`` 'tcp://host:port' with ``rank`` and ``world_size``,
    or None for the env rendezvous (MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE, as ``torchrun`` sets them).  On NCCL each process takes
    ``device``, or the card of its rank (modulo the cards visible) when
    none is given.  Returns the default group."""
    if backend == "nccl" and device is not None:
        torch.cuda.set_device(device)
    kw = {} if rank is None else dict(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    if backend == "nccl" and device is None:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.group.WORLD


BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class World:
    """One process's place in the data-parallel world of an entry point:
    its ``rank`` of ``size``, its ``device``, the ``backend`` and ``group``
    (None in a world of one, where no process group exists)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def close(self) -> None:
        """Leave the process group (nothing in a world of one)."""
        if self.distributed:
            dist.destroy_process_group()


def rank_device(device_arg=None, local_rank: int = 0) -> torch.device:
    """A rank's device: ``cuda:(local_rank % cards)`` for None or a bare
    'cuda' (raises without a card), anything else as given ('cpu' is how
    tests ask for the CPU)."""
    from univs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device_arg)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_from_env(device_arg=None, backend: Optional[str] = None,
                  environ: Optional[dict] = None) -> World:
    """The world ``torchrun`` describes (RANK / WORLD_SIZE / LOCAL_RANK /
    LOCAL_WORLD_SIZE, the env rendezvous): the counterpart of
    ``init_multihost`` + ``make_mesh``'s data axis for an entry point.
    Without WORLD_SIZE it is a world of one on ``device_arg``'s device, and
    no process group is made.

    ``backend`` (``--dist-backend``): None takes NCCL on the card and gloo
    on the CPU, the one backend each can use.  NCCL needs a card of its
    own for every rank of a host: ranks that share one (more local ranks
    than cards, or one card named for all) are refused unless gloo is asked
    for, so the backend never changes behind the caller's back."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" not in env:
        return World(0, 1, rank_device(device_arg))
    rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    device = rank_device(device_arg, local_rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"--dist-backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        shared = (device.type != "cuda" or local_size > torch.cuda.device_count()
                  or (device_arg is not None and torch.device(device_arg).index is not None
                      and local_size > 1))
        if shared:
            raise ValueError(
                f"NCCL needs one card a rank: {local_size} local ranks on {device}; "
                "pass --dist-backend gloo to share it")
    group = init_distributed(backend, None, device=device)
    return World(rank, size, device, backend, group)


def shard_slice(total: int, rank: int, world_size: int) -> slice:
    """Rank ``rank``'s contiguous videos of ``total``: the first
    ``total % world_size`` ranks take one more."""
    base, extra = divmod(total, world_size)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (rank < extra))


def shard_batch(batch, rank: int, world_size: int):
    """A ``TrainBatch``'s videos of one rank (the counterpart of
    ``batch_sharding``): a contiguous slice of the leading video axis of
    every per-video field and of the targets; the class bank replicated."""
    sl = shard_slice(batch.images.shape[0], rank, world_size)
    take = lambda v: None if v is None else v[sl]
    out = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    for name, v in out.items():
        if name == "targets":
            out[name] = dataclasses.replace(
                v, **{f.name: take(getattr(v, f.name)) for f in dataclasses.fields(v)})
        elif name not in SHARED_FIELDS:
            out[name] = take(v)
    return type(batch)(**out)


def make_train_step(cfg, model, task: str = "detection", group=None, timings=None, mesh=None):
    """The data-parallel train step of one task family: each process
    calls ``step(state, its_shard_of_the_batch, key)`` with the same key
    and an identical state; the state advances as the one-process step's
    on the global batch, and the logged losses are the global ones on
    every rank (``timings`` also gets 'allreduce_ms').  The processes are
    process group ``group``'s, or ``mesh``'s (``parallel/mesh.make_mesh``),
    whose data groups shard the batch and whose frame groups split the
    clip's frames; not both."""
    from univs_tpu_torch.parallel import train_state
    from univs_tpu_torch.parallel.mesh import data_mesh

    if mesh is not None and group is not None:
        raise ValueError("give the step a process group or a mesh, not both")
    return train_state.make_train_step(cfg, model, task, timings=timings,
                                       mesh=data_mesh(group) if mesh is None else mesh)
