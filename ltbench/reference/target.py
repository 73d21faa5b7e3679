"""Holds a downsync's target folder to the version it should hold."""

from __future__ import annotations

import hashlib

import numpy as np


def folders(tree: dict) -> set:
    out = set()
    for path in tree:
        parts = path.split("/")
        out.update("/".join(parts[:k]) for k in range(1, len(parts)))
    return out


def check_target(files: dict, dirs: set, want: dict,
                 detail: list | None = None) -> dict:
    """files: path -> bytes of every file in the target; dirs: its
    folders; want: path -> bytes of the version.  detail, where given,
    gets (path, what is wrong) of each file that differs."""
    differing = 0
    why = []
    for path, data in want.items():
        got = files.get(path)
        if got is None:
            continue
        n = min(len(got), len(data))
        diff = np.flatnonzero(np.frombuffer(got, np.uint8, n) != data[:n])
        if len(diff) or len(got) != len(data):
            differing += len(diff) + abs(len(got) - len(data))
            why.append((path, f"{len(diff)} bytes differ from offset "
                        f"{int(diff[0]) if len(diff) else n}; size "
                        f"{len(got)} of {len(data)}"))
    wrong = (set(files) ^ set(want)) | (set(dirs) ^ folders(want))
    why += [(p, "present in one of target and version only")
            for p in sorted(wrong)]
    if detail is not None:
        detail += why
    paths = len(wrong)
    return {"target_bytes_differing": differing,
            "target_paths_differing": paths}


def digests(tree: dict) -> dict:
    """path -> sha1 of each file of a version."""
    return {path: hashlib.sha1(np.ascontiguousarray(data)).digest()
            for path, data in tree.items()}


def check_digests(got: dict, dirs: set, want: dict, want_digests: dict,
                  detail: list | None = None) -> dict:
    """got: path -> sha1 of every file that a downsync left in the client
    folder; dirs: its folders; want: the version; want_digests: its
    digests().  Counts the files whose bytes differ or that are in one
    of the two only, and the folders in one only."""
    wrong = sorted(p for p in set(got) | set(want_digests)
                   if got.get(p) != want_digests.get(p))
    wrong_dirs = sorted(set(dirs) ^ folders(want))
    if detail is not None:
        detail += [(p, "bytes differ, or in one of target and version only")
                   for p in wrong + wrong_dirs]
    return {"target_files_differing": len(wrong) + len(wrong_dirs)}
