"""The version index that longtail makes of a tree, built from the tree's
bytes alone.

Layout of the ``.lvi`` (src/longtail.c:2552-2706, version 0.0.2 at :18):
a header of six u32 (version, hash identifier, target chunk size, asset
count, chunk count, asset chunk index count), then per asset the path
hashes, content hashes and sizes (u64), chunk counts and chunk index
starts (u32), the asset chunk indexes (u32), per unique chunk its hash
(u64), size and tag (u32), per asset its name offset (u32) and
permissions (u16), and the nul-terminated utf-8 paths.

Assets are every file and folder under the root (folders with a trailing
``/``), ordered by their path components.  A file's content hash is the
hash of its chunk hashes as u64 little-endian bytes (src/longtail.c:
2518-2537), a path's hash the hash of its utf-8 bytes (:1269-1279), and
unique chunks keep the order of their first occurrence (:2949-2972).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ltbench.reference import blake3, hpcdc

VERSION = 2


@dataclasses.dataclass
class Index:
    lvi: bytes
    flat: np.ndarray            # every file's bytes, in asset order
    chunk_start: dict           # unique chunk hash -> offset in flat
    chunk_size: dict            # unique chunk hash -> size
    source_bytes: int


def entries(tree: dict) -> list:
    """(path, size, permissions) of every file and folder, in the order
    of their path components."""
    out = {}
    for path, data in tree.items():
        out[path] = (len(data), 0o644)
        parts = path.split("/")
        for k in range(1, len(parts)):
            out["/".join(parts[:k]) + "/"] = (0, 0o755)
    return [(p, *out[p]) for p in sorted(out, key=lambda p: p.split("/"))]


def build(tree: dict, cfg: dict, device, hash_bits: int = 64) -> Index:
    """The index of tree; hash_bits below 64 cuts every chunk hash to
    its low bits (the control's broken guarantee)."""
    ents = entries(tree)
    files = [(p, n) for p, n, _ in ents if not p.endswith("/")]
    flat = np.concatenate([tree[p] for p, _ in files] or
                          [np.zeros(0, np.uint8)])
    starts = np.concatenate([[0], np.cumsum([n for _, n in files])[:-1]]) \
        .astype(np.int64)
    data = torch.from_numpy(flat).to(device)
    target = int(cfg["target_chunk_size"])
    sizes = hpcdc.chunk_files(data, list(zip(starts, (n for _, n in files))),
                              target)
    c_size = np.array([s for f in sizes for s in f], np.int64)
    c_start = np.concatenate([
        st + np.concatenate([[0], np.cumsum(f)[:-1]]).astype(np.int64)
        for st, f in zip(starts, sizes) if f] or [np.zeros(0, np.int64)])
    c_hash = blake3.hash64(data, c_start, c_size) & \
        np.uint64((1 << hash_bits) - 1)
    del data

    per_file = {}
    at = 0
    for (path, _), f in zip(files, sizes):
        per_file[path] = (at, len(f))
        at += len(f)
    paths = [p for p, _, _ in ents]
    counts = np.array([per_file.get(p, (0, 0))[1] for p in paths], np.uint32)
    order = np.concatenate([
        np.arange(per_file[p][0], per_file[p][0] + per_file[p][1])
        for p in paths if p in per_file] or [np.zeros(0, np.int64)]) \
        .astype(np.int64)
    ref_hashes = c_hash[order]
    uniq, first, inverse = np.unique(ref_hashes, return_index=True,
                                     return_inverse=True)
    by_first = np.argsort(first, kind="stable")
    rank = np.empty_like(by_first)
    rank[by_first] = np.arange(len(by_first))
    chunk_hashes = uniq[by_first]
    chunk_sizes = c_size[order][first[by_first]]

    msgs = [p.encode("utf-8") for p in paths]
    bounds = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
    msgs += [ref_hashes[bounds[i]:bounds[i + 1]].astype("<u8").tobytes()
             for i in range(len(paths))]
    small = blake3.hash64_bytes(msgs)
    path_hashes, content_hashes = small[:len(paths)], small[len(paths):]

    names = [p.encode("utf-8") + b"\0" for p in paths]
    name_offsets = np.concatenate([[0], np.cumsum([len(x) for x in names])
                                   [:-1]]).astype("<u4")
    tag = int(cfg["compression_tag"])
    header = np.array([VERSION, int(cfg["hash_identifier"]), target,
                       len(paths), len(chunk_hashes), len(order)], "<u4")
    lvi = b"".join([
        header.tobytes(),
        path_hashes.astype("<u8").tobytes(),
        content_hashes.astype("<u8").tobytes(),
        np.array([n for _, n, _ in ents], "<u8").tobytes(),
        counts.astype("<u4").tobytes(),
        (bounds[:-1]).astype("<u4").tobytes(),
        rank[inverse].astype("<u4").tobytes(),
        chunk_hashes.astype("<u8").tobytes(),
        chunk_sizes.astype("<u4").tobytes(),
        np.full(len(chunk_hashes), tag, "<u4").tobytes(),
        name_offsets.tobytes(),
        np.array([m for _, _, m in ents], "<u2").tobytes(),
        b"".join(names)])
    first_at = c_start[order][first[by_first]]
    return Index(
        lvi=lvi, flat=flat,
        chunk_start=dict(zip(chunk_hashes.tolist(), first_at.tolist())),
        chunk_size=dict(zip(chunk_hashes.tolist(), chunk_sizes.tolist())),
        source_bytes=int(len(flat)))


def bytes_differing(a: bytes, b: bytes) -> int:
    """Bytes that differ between a and b, a length difference counting
    in full."""
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n) != np.frombuffer(b, np.uint8, n)
    return int(np.count_nonzero(x)) + abs(len(a) - len(b))
