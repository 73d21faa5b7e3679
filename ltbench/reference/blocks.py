"""Reads back a block store that longtail wrote and holds every block to
the reference's chunks.

Formats (little-endian), from longtail's public source:

- a block file ``chunks/<first 4 hex>/0x<16 hex>.lrb``
  (lib/fsblockstore/longtail_fsblockstore.c:66-92) holds the block index
  (u64 block hash, u32 hash identifier, u32 chunk count, u32 tag, u64
  chunk hashes, u32 chunk sizes; src/longtail.c:3585-3601) and then the
  chunks' bytes; the block hash is the hash of the chunk hashes' bytes
  (:3744-3747);
- a tag other than 0 stores ``[u32 raw size][u32 compressed size]`` and
  the compressed bytes (lib/compressblockstore/
  longtail_compressblockstore.c:118-139): a zstd frame, or an LZ4 block;
- ``store.lsi``: u32 version, hash identifier, block count, chunk count;
  u64 block hashes; u64 chunk hashes; u32 per block its first chunk,
  chunk count and tag; u32 chunk sizes (src/longtail.c:8913-9048).

Blocks decode through the system's upstream libzstd and liblz4, which
share no code with the program's codecs on the card.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ltbench.reference import blake3

_BLOCK = struct.Struct("<QIII")
_SIZES = struct.Struct("<II")


class _Codecs:
    def __init__(self):
        zstd = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
        zstd.ZSTD_decompress.restype = ctypes.c_size_t
        zstd.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_void_p, ctypes.c_size_t]
        zstd.ZSTD_isError.restype = ctypes.c_uint
        zstd.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lz4 = ctypes.CDLL(ctypes.util.find_library("lz4") or "liblz4.so.1")
        lz4.LZ4_decompress_safe.restype = ctypes.c_int
        lz4.LZ4_decompress_safe.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_int]
        self.zstd, self.lz4 = zstd, lz4

    def decode(self, kind: str, payload: np.ndarray, raw: int):
        out = np.empty(max(raw, 1), np.uint8)
        src = np.ascontiguousarray(payload)
        if kind == "zstd":
            n = self.zstd.ZSTD_decompress(out.ctypes.data, raw,
                                          src.ctypes.data, len(src))
            if self.zstd.ZSTD_isError(n):
                return None
        elif kind == "lz4":
            n = self.lz4.LZ4_decompress_safe(src.ctypes.data, out.ctypes.data,
                                             len(src), raw)
            if n < 0:
                return None
        else:
            return None
        return out[:n]


def _parse_block(blob: bytes):
    block_hash, hash_id, count, tag = _BLOCK.unpack_from(blob, 0)
    off = _BLOCK.size
    hashes = np.frombuffer(blob, "<u8", count, off)
    sizes = np.frombuffer(blob, "<u4", count, off + 8 * count)
    return block_hash, hash_id, tag, hashes, sizes, off + 12 * count


def parse_lsi(blob: bytes) -> dict:
    """block hash -> (chunk hashes, chunk sizes, tag) of a store index."""
    _, _, n_blocks, n_chunks = struct.unpack_from("<4I", blob, 0)
    off = 16
    bh = np.frombuffer(blob, "<u8", n_blocks, off)
    off += 8 * n_blocks
    ch = np.frombuffer(blob, "<u8", n_chunks, off)
    off += 8 * n_chunks
    first, count, tags = (np.frombuffer(blob, "<u4", n_blocks,
                                        off + 4 * n_blocks * k)
                          for k in range(3))
    off += 12 * n_blocks
    cs = np.frombuffer(blob, "<u4", n_chunks, off)
    return {int(h): (ch[f:f + c].tobytes(), cs[f:f + c].tobytes(), int(t))
            for h, f, c, t in zip(bh, first.astype(np.int64),
                                  count.astype(np.int64), tags)}


def lsi_differing(lsi: bytes | None, judged: bytes | None) -> int:
    """Entries in which a store index differs from one already judged
    against the same blocks, in any order of blocks."""
    if lsi is None or judged is None:
        return int(lsi is not judged)
    a, b = parse_lsi(lsi), parse_lsi(judged)
    return sum(a.get(h) != v for h, v in b.items()) + len(set(a) - set(b))


def check_store(files: dict, ref, cfg: dict, root: str = "store",
                fresh: bool = True, detail: list | None = None,
                verdicts: dict | None = None) -> dict:
    """The numbers that judge a store: files maps each path under the
    store's storage to its bytes; ref is the reference's Index.  In a
    fresh store every stored chunk must be one of the reference's; in a
    store that held an earlier version, chunks that the reference does
    not know are only counted against their block's size.  detail, where
    given, gets (path, what is wrong) of each bad block.  verdicts, where
    given, keeps each block's verdict by the identity of its bytes
    object, so that blocks shared by several stores of one run (a patch
    store's blocks of the earlier version) are decoded once."""
    codecs = _Codecs()
    tag = int(cfg["compression_tag"])
    kind = cfg["compression"]
    prefix = f"{root}/chunks/"
    blocks = {p: b for p, b in files.items() if p.startswith(prefix)}

    def judge(item):
        path, blob = item
        try:
            bh, hid, btag, hashes, sizes, off = _parse_block(blob)
        except (struct.error, ValueError):
            return path, None, None, None, "unreadable block index"
        name = f"{bh:016x}"
        if path != f"{prefix}{name[:4]}/0x{name}.lrb":
            return path, bh, hashes, sizes, "file name is not its hash"
        if hid != int(cfg["hash_identifier"]) or btag != tag:
            return path, bh, hashes, sizes, f"hash id {hid:#x}, tag {btag:#x}"
        raw = int(sizes.astype(np.int64).sum())
        body = np.frombuffer(blob, np.uint8, offset=off)
        data = body
        if btag:
            size, comp = _SIZES.unpack_from(blob, off)
            if size != raw or 8 + comp != len(body):
                return path, bh, hashes, sizes, \
                    f"header sizes {size}, {comp} for {raw}, {len(body) - 8}"
            data = codecs.decode(kind, body[8:8 + comp], raw)
        if data is None or len(data) != raw:
            return path, bh, hashes, sizes, \
                f"decodes to {None if data is None else len(data)} of {raw}"
        at = 0
        for i, (h, n) in enumerate(zip(hashes.tolist(), sizes.tolist())):
            start = ref.chunk_start.get(h)
            if start is None:
                if fresh:
                    return path, bh, hashes, sizes, f"chunk {i} unknown"
            elif ref.chunk_size[h] != n:
                return path, bh, hashes, sizes, f"chunk {i} size {n}"
            else:
                want = ref.flat[start:start + n]
                diff = np.flatnonzero(data[at:at + n] != want)
                if len(diff):
                    return path, bh, hashes, sizes, (
                        f"chunk {i} of {len(sizes)}: {len(diff)} of {n} "
                        f"bytes differ, first at block offset "
                        f"{at + int(diff[0])} of {raw}")
            at += n
        return path, bh, hashes, sizes, None

    verdicts = {} if verdicts is None else verdicts
    todo = [item for item in sorted(blocks.items())
            if id(item[1]) not in verdicts]
    with ThreadPoolExecutor(8) as pool:
        for item, verdict in zip(todo, pool.map(judge, todo)):
            verdicts[id(item[1])] = verdict
    judged = [verdicts[id(b)] for _, b in sorted(blocks.items())]
    stored = [j for j in judged if j[1] is not None]
    want = blake3.hash64_bytes([j[2].tobytes() for j in stored])
    why = [(j[0], j[4]) for j in judged if j[4]] + [
        (j[0], "block hash is not the hash of its chunk hashes")
        for w, j in zip(want, stored) if int(w) != j[1] and not j[4]]
    if detail is not None:
        detail += why
    bad = len(why)
    held = Counter(h for j in stored for h in j[2].tolist())
    lsi_blob = files.get(f"{root}/store.lsi")
    lsi = parse_lsi(lsi_blob) if lsi_blob is not None else {}
    on_disk = {j[1]: (j[2].tobytes(), j[3].tobytes(), tag) for j in stored}
    lsi_diff = sum(lsi.get(h) != v for h, v in on_disk.items()) + \
        len(set(lsi) - set(on_disk)) + (lsi_blob is None)
    stored_bytes = sum(len(b) for b in blocks.values()) + \
        len(lsi_blob or b"")
    return {
        "blocks_bad": bad,
        "chunks_missing": sum(h not in held for h in ref.chunk_start),
        "chunks_stored_twice": sum(c > 1 for c in held.values()),
        "lsi_entries_differing": lsi_diff,
    }, stored_bytes
