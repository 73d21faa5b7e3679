"""Builds and binds the port's CUDA kernels (``csrc/*.cu``).

The counterpart of ``longtail_tpu/native/__init__.py``, except that it
fails loudly: there is no host fallback for a kernel, so a missing
``nvcc`` or a failed build raises instead of returning None.

At first use ``load()`` compiles every ``csrc/*.cu`` with plain nvcc for
``sm_90a``, one nvcc process per source, all started together, and links
the objects into ``build/longtail_tpu_torch/libltkernels.so`` (beside the
package), with a C interface bound through ctypes.  It rebuilds when a
source, or this file, is newer than the library.  The algorithm constants
(BLAKE3 IV, message permutation and flags, BLAKE2s IV, SIGMA and
parameter word, the HPCDC window, the anchor gram hash, the walk's
shared-memory state cap, the Huffman code and stream limits) reach the CUDA sources as ``-D`` macros taken
from the Python modules, so the sources hold no copy of them.

Every entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; the Python wrappers make the tensors'
device current around the call, raise when it returns non-zero, and
count the launch with ``count_launch`` (the block codecs call the
wrappers from several threads at once).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading


_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "longtail_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libltkernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint32

# name -> argtypes; every pointer and the stream are c_void_p
_SIGNATURES = {
    # bytes, lengths, table, min1, min2, cnt, bins (or NULL), n_bytes,
    # part_bytes, log2(z), inv, lim, shift, stream
    "lt_stage1_scan": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _U, _U, _I,
                       _P],
    # lengths, min1, min2, cnt, scratch32, scratch8, out, n_parts,
    # part_bytes, seg_per_part, log2(z), min_size, max_size, c_pad, stream
    "lt_stage1_walk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P],
    # words, n_words, starts, sizes, out, rows, row_words, stream
    "lt_pack": [_P, _LL, _P, _P, _P, _I, _I, _P],
    # bytes, n_bytes, starts, sizes, plan, out, n_chunks, n_blocks, stream
    "lt_blake3": [_P, _LL, _P, _P, _P, _P, _I, _I, _P],
    # bytes, n_bytes, starts, sizes, order, out, n_chunks, stream
    "lt_blake2": [_P, _LL, _P, _P, _P, _P, _I, _P],
    # lits, n_lits, streams, tables, words, totals, n_streams, n_tables,
    # n_words, stream
    "lt_hufpack": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _P],
    # lits, n_lit, table, words, totals, work, n_rows, n_pad, row_words,
    # zero_words, epoch, base, stream
    "lt_hufpack_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U,
                        _P],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def defines() -> list[str]:
    """The algorithm constants as nvcc -D flags, from the Python modules."""
    from longtail_tpu_torch.formats.constants import CHUNKER_WINDOW_SIZE
    from longtail_tpu_torch.ops import blake2 as b2
    from longtail_tpu_torch.ops import blake3 as b3
    from longtail_tpu_torch.ops import entropy_kernel as ek
    from longtail_tpu_torch.parallel import device_match as dm
    from longtail_tpu_torch.parallel import stage1

    # one macro per value: nvcc splits a -D value at commas.  A BLAKE2s
    # SIGMA round is one value, its 16 indices packed 4 bits each, slot 0
    # lowest.
    sigma = [sum(int(x) << (4 * i) for i, x in enumerate(r))
             for r in b2.SIGMA]
    return [
        *(f"-DLT_BLAKE3_IV{i}={int(x):#x}u" for i, x in enumerate(b3.IV)),
        *(f"-DLT_BLAKE3_PERM{i}={int(x)}" for i, x in enumerate(b3.PERM)),
        f"-DLT_BLAKE3_CHUNK_START={int(b3.CHUNK_START)}u",
        f"-DLT_BLAKE3_CHUNK_END={int(b3.CHUNK_END)}u",
        f"-DLT_BLAKE3_PARENT={int(b3.PARENT)}u",
        f"-DLT_BLAKE3_ROOT={int(b3.ROOT)}u",
        f"-DLT_BLAKE3_BLOCK_BYTES={int(b3.BLOCK_BYTES)}",
        f"-DLT_BLAKE3_LEAF_BYTES={int(b3.LEAF_BYTES)}",
        f"-DLT_BLAKE3_THREADS={int(b3.BLOCK_LEAVES)}",
        f"-DLT_BLAKE3_MAX_LEAVES={int(b3.MAX_LEAVES)}",
        *(f"-DLT_BLAKE2_IV{i}={int(x):#x}u"
          for i, x in enumerate(b2.IV)),
        *(f"-DLT_BLAKE2_SIGMA{r}={v:#x}ull" for r, v in enumerate(sigma)),
        f"-DLT_BLAKE2_PARAM0={int(b2.PARAM0):#x}u",
        f"-DLT_BLAKE2_BLOCK_BYTES={int(b2.BLOCK_BYTES)}",
        f"-DLT_HPCDC_WINDOW={int(CHUNKER_WINDOW_SIZE)}",
        f"-DLT_GRAM_H0={dm.GRAM_H0:#x}u",
        f"-DLT_GRAM_H1={dm.GRAM_H1:#x}u",
        f"-DLT_BIN_WORDS={dm.BIN_WORDS}",
        f"-DLT_WALK_CAP={stage1.WALK_CAP}",
        f"-DLT_HUF_MAX_BITS={ek.MAX_HUF_BITS}",
        f"-DLT_HUF_MAX_LITS={ek.MAX_STREAM_LITS}",
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


def compile_command(nvcc: str, src: str, obj: str) -> list[str]:
    return [nvcc, *NVCC_FLAGS, *defines(), "-c", src, "-o", obj]


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    from longtail_tpu_torch.formats import constants
    from longtail_tpu_torch.ops import blake2, blake3, entropy_kernel, zstd_frame
    from longtail_tpu_torch.parallel import device_match, stage1

    # the sources, and the Python modules their -D constants come from
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh")) + [
        __file__, device_match.__file__, constants.__file__,
        blake2.__file__, blake3.__file__, stage1.__file__,
        entropy_kernel.__file__, zstd_frame.__file__]
    return os.path.getmtime(LIB_PATH) < max(os.path.getmtime(p) for p in deps)


def _build() -> None:
    nvcc = find_nvcc()                        # raises when nvcc is missing
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in sources()]
    try:
        procs = [subprocess.Popen(compile_command(nvcc, src, obj),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources(), objs)]
        errors = []
        for src, proc in zip(sources(), procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(src)} (exit "
                              f"{proc.returncode}):\n{err[-4000:]}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = f"{LIB_PATH}.{tag}"
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{proc.stderr[-8000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


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


def count_launch(wrapper) -> None:
    """wrapper.LAUNCHES += 1, under a lock: read-modify-write is not
    atomic across threads."""
    with _COUNT_LOCK:
        wrapper.LAUNCHES += 1


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
