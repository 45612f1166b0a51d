"""COCO RLE encode/decode in numpy (the port's copy of the numpy encoder
of ``univs_tpu/utils/rle.py:57-122,182``).  Column-major runs,
delta/base-32 character encoding — the public COCO RLE spec, giving the
same dicts as pycocotools and the JAX package."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _counts_from_mask(mask: np.ndarray) -> np.ndarray:
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    changes = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(bounds)
    if flat.size and flat[0] == 1:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def _string_from_counts(counts: np.ndarray) -> str:
    s = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = x != -1 if (ch & 0x10) else x != 0
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return "".join(s)


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


def encode(mask: np.ndarray) -> Dict:
    """Binary mask [H, W] -> {"size": [H, W], "counts": str}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _string_from_counts(_counts_from_mask(mask))}


def decode(rle: Dict) -> np.ndarray:
    """{"size": [H, W], "counts": str} -> binary mask [H, W] uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    flat = np.zeros(h * w, np.uint8)
    pos, v = 0, 0
    for c in _counts_from_string(counts):
        c = min(c, h * w - pos)
        if v:
            flat[pos:pos + c] = 1
        pos += c
        v = 1 - v
        if pos >= h * w:
            break
    return flat.reshape(h, w, order="F")
