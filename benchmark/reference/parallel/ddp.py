"""The batch shard of one process holding the whole batch: the
reference runs the global batch in one process, so every method of the
program's ``BatchShard`` is the identity here."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class BatchShard:
    offset: int
    local: int
    total: int
    distributed: bool = False

    @staticmethod
    def whole(b: int) -> "BatchShard":
        return BatchShard(0, b, b)

    def count(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def split(self, key):
        return key.split(self.total)[self.offset:self.offset + self.local]

    def rows_total(self, rows: int) -> int:
        return rows

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        return x
