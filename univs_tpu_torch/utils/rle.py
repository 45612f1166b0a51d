"""COCO RLE encode / decode / area / intersection / IoU (the port's copy of
``univs_tpu/utils/rle.py``), with a native encoder.

Column-major runs, delta/base-32 character encoding: the public COCO RLE
spec, giving the same dicts as pycocotools and the JAX package.  The
native path is ``univs_tpu_torch/csrc/rle.cpp`` (a copy of the JAX
package's ``csrc/rle.cpp``), built with ``g++ -O3 -shared -fPIC`` at first
use into ``build/rle/`` at the repository root (listed in ``.gitignore``;
never beside the source) and loaded with ctypes.  The numpy law
(``*_numpy``) is its plain version: the tests hold the two to each other
byte for byte.  The backend is decided once per process (``backend()``):
if g++ or the build fails, a warning carries the compiler's stderr and
every call takes the numpy law.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import subprocess
import tempfile
from typing import Dict, List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "rle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rle")
LIB_PATH = os.path.join(BUILD_DIR, "librle.so")

_P = ctypes.c_void_p
_SIGNATURES = {
    # mask (column-major h*w bytes), h, w, out -> length
    "rle_encode": ([_P, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    # counts string, h, w, mask out -> 0
    "rle_decode": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "rle_area": ([ctypes.c_char_p], ctypes.c_int64),
    "rle_intersection": ([ctypes.c_char_p, ctypes.c_char_p], ctypes.c_int64),
}


def _build() -> None:
    """Compile ``SOURCE`` into ``LIB_PATH`` through a temporary file renamed
    into place, so processes building at once never load a partial file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SOURCE],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def _native() -> Optional[ctypes.CDLL]:
    """The native library, built when missing or older than its source;
    None (with a warning) when it cannot be built or loaded."""
    try:
        if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE):
            _build()
        lib = ctypes.CDLL(LIB_PATH)
    except subprocess.CalledProcessError as e:
        logging.getLogger(__name__).warning(
            "building %s failed, RLE takes the numpy law:\n%s", SOURCE, e.stderr)
        return None
    except OSError as e:  # no g++, or a library that does not load
        logging.getLogger(__name__).warning(
            "native RLE unavailable (%s), RLE takes the numpy law", e)
        return None
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def backend() -> str:
    """``"native"`` when ``csrc/rle.cpp`` is built and loaded, else ``"numpy"``."""
    return "native" if _native() is not None else "numpy"


def _ascii(counts) -> bytes:
    return counts if isinstance(counts, bytes) else counts.encode("ascii")


# ---------------------------------------------------------------------------
# numpy law (the plain version)
# ---------------------------------------------------------------------------


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


def _text(counts) -> str:
    return counts.decode("ascii") if isinstance(counts, bytes) else counts


def encode_numpy(mask: np.ndarray) -> Dict:
    h, w = mask.shape
    m = np.asfortranarray(mask).astype(np.uint8)
    return {"size": [int(h), int(w)], "counts": _string_from_counts(_counts_from_mask(m))}


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


def area_numpy(rle: Dict) -> int:
    return int(sum(_counts_from_string(_text(rle["counts"]))[1::2]))


def intersection_numpy(a: Dict, b: Dict) -> int:
    return int(np.logical_and(decode_numpy(a), decode_numpy(b)).sum())


# ---------------------------------------------------------------------------
# public API (pycocotools-compatible dicts)
# ---------------------------------------------------------------------------


def encode(mask: np.ndarray) -> Dict:
    """Binary mask [H, W] -> {"size": [H, W], "counts": str}."""
    lib = _native()
    if lib is None:
        return encode_numpy(mask)
    h, w = mask.shape
    m = np.asfortranarray(mask, dtype=np.uint8)
    out = np.empty(6 * h * w + 16, np.uint8)  # rle_encode's documented capacity
    n = lib.rle_encode(m.ctypes.data, h, w, out.ctypes.data)
    return {"size": [int(h), int(w)], "counts": out[:n].tobytes().decode("ascii")}


def decode(rle: Dict) -> np.ndarray:
    """{"size": [H, W], "counts": str or bytes} -> binary mask [H, W] uint8."""
    lib = _native()
    if lib is None:
        return decode_numpy(rle)
    h, w = rle["size"]
    m = np.empty(h * w, np.uint8)
    lib.rle_decode(_ascii(rle["counts"]), h, w, m.ctypes.data)
    return m.reshape(h, w, order="F")


def area(rle: Dict) -> int:
    lib = _native()
    if lib is None:
        return area_numpy(rle)
    return int(lib.rle_area(_ascii(rle["counts"])))


def intersection(a: Dict, b: Dict) -> int:
    """Pixels set in both masks (the native path merges the runs, the
    numpy law decodes both)."""
    lib = _native()
    if lib is None:
        return intersection_numpy(a, b)
    return int(lib.rle_intersection(_ascii(a["counts"]), _ascii(b["counts"])))


def iou(a: Dict, b: Dict) -> float:
    inter = intersection(a, b)
    union = area(a) + area(b) - inter
    return inter / union if union > 0 else 0.0


def encode_mask_batch(masks: np.ndarray) -> List[Dict]:
    """[N, H, W] -> list of RLE dicts."""
    return [encode(m) for m in masks]
