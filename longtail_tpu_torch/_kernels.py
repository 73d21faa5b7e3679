"""Builds and binds the port's CUDA kernels (``csrc/*.cu``).

The counterpart of ``longtail_tpu/native/__init__.py``, except that it
fails loudly: there is no host fallback for a kernel, so a missing
``nvcc`` or a failed build raises instead of returning None.

At first use ``load()`` compiles every ``csrc/*.cu`` with plain nvcc for
``sm_90a`` into ``build/longtail_tpu_torch/libltkernels.so`` (beside the
package), with a C interface bound through ctypes.  It rebuilds when a
source, or this file, is newer than the library.  The algorithm constants
(BLAKE3 IV, message permutation and flags, the HPCDC window) reach the
CUDA sources as ``-D`` macros taken from the host modules, so the sources
hold no copy of them.

Every entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; the Python wrappers make the tensors'
device current around the call and raise when it returns non-zero.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

from longtail_tpu_torch import _host

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "longtail_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libltkernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint32

# name -> argtypes; every pointer and the stream are c_void_p
_SIGNATURES = {
    # bytes, lengths, table, min1, min2, cnt, n_bytes, part_bytes, z, d,
    # stream
    "lt_stage1_scan": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _U, _P],
    # lengths, min1, min2, cnt, suf, out, n_parts, part_bytes,
    # seg_per_part, log2(z), min_size, max_size, c_pad, stream
    "lt_stage1_walk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    # words, n_words, starts, sizes, out, rows, row_words, stream
    "lt_pack": [_P, _LL, _P, _P, _P, _I, _I, _P],
    # words, lengths, out, rows, row_words, stream
    "lt_blake3": [_P, _P, _P, _I, _I, _P],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def defines() -> list[str]:
    """The algorithm constants as nvcc -D flags, from the host modules."""
    b3 = _host.host_blake3
    # one macro per word: nvcc splits a -D value at commas
    return [
        *(f"-DLT_BLAKE3_IV{i}={int(x):#x}u" for i, x in enumerate(b3.IV)),
        *(f"-DLT_BLAKE3_PERM{i}={int(x)}" for i, x in enumerate(b3.PERM)),
        f"-DLT_BLAKE3_CHUNK_START={int(b3.CHUNK_START)}u",
        f"-DLT_BLAKE3_CHUNK_END={int(b3.CHUNK_END)}u",
        f"-DLT_BLAKE3_PARENT={int(b3.PARENT)}u",
        f"-DLT_BLAKE3_ROOT={int(b3.ROOT)}u",
        f"-DLT_BLAKE3_BLOCK_BYTES={int(b3.BLOCK_BYTES)}",
        f"-DLT_BLAKE3_LEAF_BYTES={int(b3.LEAF_BYTES)}",
        f"-DLT_HPCDC_WINDOW={int(_host.constants.CHUNKER_WINDOW_SIZE)}",
    ]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda"
        "/bin): the CUDA kernels of longtail_tpu_torch cannot be built")


def build_command(out_path: str) -> list[str]:
    return [find_nvcc(), *NVCC_FLAGS, *defines(), "-o", out_path, *sources()]


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh")) + [__file__]
    return os.path.getmtime(LIB_PATH) < max(os.path.getmtime(p) for p in deps)


def _build() -> None:
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = build_command(tmp)                  # raises when nvcc is missing
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-8000:]}")
    os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """The kernel library, built if missing or stale; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if _stale():
                _build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream of t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(name: str, t, dtype, shape=None, device=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape /
    device when given) — what a kernel entry point takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
