"""The decode of a COCO run-length encoding in numpy (the plain law),
frozen from the port's ``utils/rle.py``: column-major counts in the
LEB128-like string form, to the binary mask."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _counts_from_string(s: str) -> List[int]:
    counts: List[int] = []
    p, n = 0, len(s)
    while p < n:
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _text(counts) -> str:
    return counts.decode("ascii") if isinstance(counts, bytes) else counts


def decode_numpy(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, v = 0, 0
    for c in _counts_from_string(_text(rle["counts"])):
        c = min(c, h * w - pos)
        if v:
            flat[pos:pos + c] = 1
        pos += c
        v = 1 - v
        if pos >= h * w:
            break
    return flat.reshape(h, w, order="F")
