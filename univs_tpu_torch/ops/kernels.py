"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), and loaded with ctypes.  All sources build in parallel
(one ``nvcc`` each, all started together).  A build or load failure
raises; nothing falls back.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel and nowhere else, so a run can show that the main path went
through the kernels (``reset_launch_counts`` / ``launch_counts``).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

KERNELS = ("msda_sample", "msda_rows", "fused_ffn_ln", "msda_tent_base", "msda_tent_plane",
           "msda_tent_probe")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # dtype, value, loc, out, N, S, Lq, M, D, P, L, shapes*, stream
    "msda_sample": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # dtype, q, wo [2*M*L*P, C], bo, wa [M*L*P, C], ba, loc, N, Lq, C, M, P, L, shapes*, stream
    "msda_rows": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # body, dtype, x, a, g1, c1, w1_t, b1, w2_t, b2, g2, c2, out, ntok, C, F, eps, stream
    "fused_ffn_ln": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     ctypes.c_float, _P],
    # dtype, int8, value, dequant, loc, out, N, S, Lq, M, D, P, L, shapes*, stream
    "msda_tent_base": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # body, dtype, outer, slab, rows, meta, out, N, Qp, RQ, M, P, H, W, D, subq, Hw, stream
    "msda_tent_plane": [_I, _I, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
    # dtype, round_bf16, slab, xs, ys, was, out, N, R, M, H, W, D, G, dmajor, flags, stream
    "msda_tent_probe": [_I, _I, _P, _P, _P, _P, _P] + [_I] * 9 + [_P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header under
    ``csrc/`` (each one the source can include)."""
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    t = os.path.getmtime(lib)
    srcs = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > t for s in srcs)


def nvcc_command(src: str, out: str) -> list:
    """The nvcc command that builds the kernel source ``src`` into the
    shared library ``out`` (sm_90a, ``-Xptxas -v``)."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC, "-o", out, src]


def build(names=KERNELS) -> Dict[str, str]:
    """Compile the named kernels that are missing or stale, all nvcc
    processes in parallel; raises with the compiler output on failure.
    Returns {name: compiler output} (``-Xptxas -v`` register/spill
    report) for what was built."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        cmd = nvcc_command(os.path.join(CSRC, f"{n}.cu"), _lib_path(n) + ".tmp")
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    out, failed = {}, []
    for n, p in procs.items():
        out[n], _ = p.communicate()
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(_lib_path(n) + ".tmp", _lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(out[n] for n in failed))
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    with _lock:
        if name not in _libs:
            build(KERNELS)
            handle = ctypes.CDLL(_lib_path(name))
            fn = getattr(handle, f"{name}_launch")
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            _libs[name] = handle
        return _libs[name]


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def shapes_arg(spatial_shapes) -> ctypes.Array:
    flat = [int(v) for hw in spatial_shapes for v in hw]
    return (ctypes.c_int * max(len(flat), 1))(*flat)


def stream_arg(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def tent_head_ok(D: int) -> bool:
    """The head sizes kernels D and F take (``csrc/tent_gather.cuh``): a
    divisor or a multiple of 32."""
    return D >= 1 and (32 % D == 0 if D < 32 else D % 32 == 0)


def load_align(D: int, t: torch.Tensor) -> int:
    """The alignment in bytes that kernels D and F need of a tensor whose
    heads of D channels a lane reads with loads of up to 16 bytes."""
    return min(16, D * t.element_size())


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
