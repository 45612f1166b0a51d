"""Faults planted in the reference put in the program's place, read as
the upper readings of a cell's comparison limits (``benchmark/control.py``;
the benchmark's own runs never plant them).  Each breaks one path only,
to show that the numbers compared see that path."""

from __future__ import annotations

import copy

import torch.nn as nn


def prompt_skip(model: nn.Module) -> nn.Module:
    """A copy of the reference whose decoder's prompt cross-attention
    returns its input: the prompt rows never read their kv, the learned
    queries' rows are untouched."""
    ctl = copy.deepcopy(model)
    ctl.decoder._proca = lambda i, output, *args: output
    return ctl


def shift_labels(labels, classes: int):
    """A label map [T, H, W] whose first frame has every pixel's class
    moved on by one (mod ``classes``): an answer altered where it is
    produced."""
    out = labels.copy()
    out[0] = (out[0] + 1) % classes
    return out
