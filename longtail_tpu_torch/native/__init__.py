"""Native host-side helpers (C, built on demand with the system compiler).

The counterpart of ``longtail_tpu/native/__init__.py``: the host runtime
paths the reference implements in C (the BLAKE3 batch hasher, the CDC
scan, the LZ4 block codec and anchor assembler, the zstd sequence walk).
Each library is built from the sources beside this file into
``build/longtail_tpu_torch/native/`` at the repository root, never beside
the sources, under a name that carries the host's CPU model: it is built
with ``-march=native``, so a library built on one machine is never
loaded on another.  A pure-Python fallback exists for every native entry
point, so the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "longtail_tpu_torch", "native")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}


def _host_tag() -> str:
    """A short digest of this machine's CPU model (the -march target)."""
    model = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model += line
                    break
    except OSError:
        pass
    return hashlib.sha1(model.encode()).hexdigest()[:10]


def _build(name: str, sources: list[str]) -> str | None:
    so_path = os.path.join(BUILD_DIR, f"lib{name}.{_host_tag()}.so")
    src_paths = [os.path.join(_DIR, s) for s in sources]
    try:
        newest_src = max(os.path.getmtime(p) for p in src_paths)
        if os.path.exists(so_path) and os.path.getmtime(so_path) >= newest_src:
            return so_path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cc = os.environ.get("CC", "cc")
        cmd = [cc, "-O3", "-march=native", "-fPIC", "-shared",
               "-o", tmp] + src_paths
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)    # atomic against a concurrent build
        return so_path
    except (OSError, subprocess.CalledProcessError):
        return None


def load(name: str, sources: list[str]) -> ctypes.CDLL | None:
    if os.environ.get("LONGTAIL_TPU_NO_NATIVE"):
        # force the pure-Python fallbacks (CI exercises them explicitly;
        # a cached .so would otherwise mask a missing compiler)
        return None
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = _build(name, sources)
        lib = None
        if so is not None:
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                lib = None
        _LIBS[name] = lib
        return lib
