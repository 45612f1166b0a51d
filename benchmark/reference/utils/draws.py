"""Random draws of the training path, addressed like JAX keys.

The JAX package derives every random draw of a train step from one key
by ``fold_in`` / ``split`` (and flax's ``make_rng``, a fold of static
names and a counter).  The port keeps that tree of addresses: a
``DrawKey`` is a path of those operations, and a draw at a key is a
function of the source and the path only, never of the order in which
draws happen.  The port's source, ``TorchSource``, seeds one
``torch.Generator`` per draw from a hash of (seed, path), on the card
unless the caller asks for the CPU (the PointRend candidates of a
full-width step are ~10^8 numbers); a test can hand in a source that replays the JAX key of the
same path, so both packages see the same draws.  A draw returns a tensor
on its source's device; the laws take its result as an argument and
move it to their device.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import torch

from benchmark.reference.utils.device import resolve_device


class TorchSource:
    """Draws from ``torch.Generator``s on ``device`` seeded by (seed,
    path); None -> the card (raises without one), "cpu" explicitly.
    The same seed gives other numbers on the card than on the CPU
    (another generator)."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = int(seed)
        self.device = resolve_device(device)

    def _gen(self, path) -> torch.Generator:
        h = hashlib.blake2b(repr((self.seed, path)).encode(), digest_size=8).digest()
        return torch.Generator(device=self.device).manual_seed(
            int.from_bytes(h, "little") & (2 ** 63 - 1))

    def _rand(self, path, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(path), dtype=torch.float32,
                          device=self.device)

    def uniform(self, path, shape, minval: float, maxval: float) -> torch.Tensor:
        return self._rand(path, shape) * (maxval - minval) + minval

    def randint(self, path, low: int, high: int) -> int:
        return int(torch.randint(low, high, (), generator=self._gen(path), device=self.device))

    def gumbel(self, path, shape) -> torch.Tensor:
        u = self._rand(path, shape).clamp(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def permutation(self, path, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self._gen(path), device=self.device)


class DrawKey:
    """A node of the tree of random streams: ``fold_in(n)``,
    ``split(k)`` and ``static(*names)`` (flax's ``make_rng`` suffix)
    return child nodes; ``uniform``, ``randint``, ``gumbel`` and
    ``permutation`` draw at this node."""

    def __init__(self, source, path: Tuple = ()):
        self.source = source
        self.path = tuple(path)

    def fold_in(self, n: int) -> "DrawKey":
        return DrawKey(self.source, self.path + (("fold", int(n)),))

    def split(self, k: int = 2) -> Sequence["DrawKey"]:
        return [DrawKey(self.source, self.path + (("split", int(k), i),)) for i in range(k)]

    def static(self, *names) -> "DrawKey":
        return DrawKey(self.source, self.path + (("static", tuple(names)),))

    def uniform(self, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
        return self.source.uniform(self.path, tuple(shape), minval, maxval)

    def randint(self, low: int, high: int) -> int:
        return self.source.randint(self.path, low, high)

    def gumbel(self, shape) -> torch.Tensor:
        return self.source.gumbel(self.path, tuple(shape))

    def permutation(self, n: int) -> torch.Tensor:
        return self.source.permutation(self.path, n)


def make_key(seed: int = 0, device=None) -> DrawKey:
    """The root key of the port's own draws, made on ``device``: None ->
    the card (raises without one), "cpu" explicitly."""
    return DrawKey(TorchSource(seed, device))
