#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (longtail_tpu_torch) on one card.

    python3 chip_smoke.py [--gib 1.0] [--blake2-gib 0.03125] [--seed 7]
                          [--kernels-only]

Phases, each printing a line; any failure raises and exits non-zero
(--kernels-only stops after phase 3, a quick first check of a changed
kernel: it prints the kernels line without launch counts and no last
line):

1. device: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles the kernels (csrc/*.cu, one nvcc per source, sm_90a);
3. kernels: each of the six kernels against its plain PyTorch version on
   the card at the main path's shapes, demanding exact equality (all
   integer), with CUDA-event times of both, the kernel's own device
   time under torch.profiler (by CUDA events behind a spin kernel where
   the profiler records no launch) and its bound (the larger of its least
   bytes over 3.35 TB/s and its integer operations over the card's
   int32 rate): scan (bins output included) and walk on one 64 MiB batch
   of 2 x 32 MiB parts, one ragged, the walk also on adversarial
   summaries (a part of zeros, dense ambiguous candidates, lengths 0,
   below min_size, ragged and whole, 64 lanes x 1 MiB, a c_pad cut to 8,
   2 x 32 MiB of 256-byte-period content) against suffix_min +
   walk_plain, each checked to reach the branch it exists for; the scan
   also at the smallest Z (128, another discriminator; on ragged parts
   and timed on the batch), at an odd discriminator (its candidate
   filter without a rotate) and on a batch that ends inside a block;
   BLAKE3 and BLAKE2 each on all of that batch's chunks in one launch
   and on an adversarial batch (odd starts, sizes 0 to 1024 leaves or
   64 KiB, a chunk ending on the batch's last byte), BLAKE2 also logging
   a model of its longest chunk's chain; pack on every size class of
   that batch's chunks plus a size-0 padding tail, and both hashes' row
   interfaces on its rows; the Huffman pack once per zstd frame on every
   Huffman section of an 8 MiB block of the structured data, and on the
   four streams of its 128 KiB zstd block with the most literals, a
   short single-stream section (both also through the (S, n_pad)
   interface) and a frame with 1-bit and 11-bit codes; and its (S, n_pad)
   interface (device_entropy's 128 x 128 KiB, 2 ragged rows of 1 MiB
   and one of 2 MiB of 1-bit and 11-bit codes, ragged 1 MiB rows whose
   last piece holds 3 literals or none, rows of one piece and of one
   piece + 16, 0-bit pieces), each call one launch of hufrows_kernel and
   no other CUDA op under the profiler, against hufpack_plain and the
   plain version of its kernel;
4. main path: the CLI's ``upsync`` of a synthetic asset tree (--gib GiB,
   default 1) on the card, which it uses by default, at the defaults
   (32 KiB target chunk, 64 MiB batches, 8 MiB blocks), with zstd (the
   default, no --device flag) and with LZ4 (bare --device), and of a
   smaller tree (--blake2-gib, default 32 MiB) with BLAKE2 (zstd blocks,
   --device cuda); each kernel's launch count is set to 0 before and
   read after each run and must be positive for every kernel of that
   path, the path's hash must launch once per batch, pack never, and
   the Huffman pack at most once per zstd frame; prints wall time,
   GB/s, compression ratio and the blocks of each route;
5. held to the host: each .lvi equals the port's host path's
   (device=None) byte for byte, a downsync of each store through the
   port's api.downsync reproduces the tree, sampled 8 MiB blocks
   recompressed with the port's codecs on the CPU equal the card's
   bytes, and the ratios stand beside host zstd level 3 and host LZ4;
6. stage 4: DevicePartIndexer(compress=True) over a few batches, anchors
   from the scan's bins equal to those from the words, every block
   assembled by the host LZ4 walk and decoded; scan, walk and BLAKE3
   each launched in the compress=True batches, pack never; prints GB/s;
7. mesh upsync: api.upsync(mesh=["cuda:0", "cuda:0"]) of the tree with
   LZ4 device codecs (two indexers on the card), its .lvi equal to
   phase 4's LZ4 .lvi, BLAKE3 once per batch over both indexers; prints
   wall and GB/s beside phase 4's LZ4 upsync;
8. distributed steps: an NCCL group of world size 1 on the card runs
   sharded_chunk_step and sharded_index_step on one 64 MiB batch of the
   tree; sizes and the unique set equal DevicePartIndexer's for it;
9. two processes: ``python -m longtail_tpu_torch.parallel.multihost``
   twice on the card (compute mode checked first), host arrays over
   gloo, LZ4 blocks; the .lvi and .lrb set equal phase 4's LZ4 run and
   the sharded downsync reproduces the tree; prints the wall;
10. pack: ``pack --device`` (zstd) of the BLAKE2 phase's smaller tree
   byte-identical to ``pack --device cpu``, and unpack reproduces it;
11. stale target: one file of the unpacked tree changed, then brought
   back three times, each run scanning the target on the card and
   reproducing the tree: a downsync of that archive with
   device="cuda", the CLI's ``unpack --device cuda`` of it, and the
   CLI's ``downsync --device`` (bare) of the BLAKE2 store;
12. device decode: decode_block_device on full 8 MiB LZ4 blocks of phase
   4's store, byte-equal to host decode; ms per block and GB/s of both;
13. bench: the nine modes of bench_torch.py (the port's bench.py) called
   in-process on the card at small sizes, ``real`` over phase 4's tree;
   each returns exactly bench.py's keys for its mode plus ``device``,
   ``verified: true`` where bench.py has that key and a value above 0,
   and prints its JSON line;
14. graft entry: ``__graft_entry_torch__.entry()``'s step on the card
   equal to its CPU run, one call launching scan, walk, pack and BLAKE3
   once each and nothing else; the same step at phase 3's batch (2 x 32
   MiB, one ragged, 32 KiB target) equal to its plain run on the CPU,
   timed by CUDA events (the plain run by the host clock); and
   ``dryrun_multichip`` over every card (the sharded steps in an NCCL
   group, the mesh upsync, two multihost processes), each leg checked
   and its launches logged;
15. faults: each scenario on a thread joined with a 120 s limit, held to
   the exception its CPU case in tests/test_torch_faults.py asserts:
   ENOSPC from the store while the card codecs write blocks (LZ4, and
   zstd with the Huffman pack); EIO from the read of a 160 MiB file's
   3rd part with a batch on the card; a source file shorter than its
   listing (StorageError "short read", mapped and read); a corrupt and a
   truncated store.lsi, under which a card upsync finds every block by a
   scan of the .lrb files and writes none again; a cancel
   during a downsync whose stale target the card re-indexed; a missing
   block file; two card upsyncs into one store at once through the .lsi
   lock; then Python's thread count back to its value before the phase
   within 5 s, and phase 4's zstd upsync again, writing phase 4's .lvi;
16. large asset: one file of 4 GiB + 4097 bytes at the library defaults,
   indexed on the host path, upsynced on the card with LZ4 (its .lvi
   equal to the host path's, an asset size past 2^32), the source
   deleted, downsynced into a fresh folder with the source's sha256;
   each step's wall, GB/s and peak RSS; works under the checkout's
   build/ (gitignored) and raises with less than 9 GiB free there.

Phases 7-11, 14 and 15, each mode of phase 13 and phase 16's upsync set
every launch count to 0 before the path and read them after (phase 9's
and phase 14's subprocesses from their own reports): scan, walk and
BLAKE3 (BLAKE2 on phase 11's BLAKE2 downsync) must launch on each of
phases 7-11, each leg of phase 14's dry run, phase 15's scenarios that
reach the card and phase 16's upsync, the Huffman pack on the zstd pack
and phase 15's zstd ENOSPC; in phase
13 the kernels of each mode's path (scan, walk, BLAKE3 for the data
plane, the mesh, real and downsync, the Huffman pack for
chunk_hash_compress's zstd context, device_entropy, real and downsync,
and its (S, n_pad) rows for device_entropy), pack and BLAKE2 never.
Pack launches in phase 14's entry() step and on no other path; the
kernels line takes its count from there.

The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.  Imports no jax and nothing of the JAX
package (longtail_tpu).
"""

from __future__ import annotations

import argparse
import filecmp
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


# the card's peaks for the bounds: HBM3 of an H100 SXM (NVIDIA's data
# sheet), and its int32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (NVIDIA's Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * CLOCK_HZ
# integer operations per 64-byte compression: 8 G functions per round of
# 12 operations each (Hopper's IADD3 adds three operands in one
# instruction, so a + b + m is one: 2 three-input adds, 2 adds, 4 xors,
# 4 rotates), and the 8 output words (BLAKE3 v[i] ^ v[i + 8]; BLAKE2s
# h[i] ^ v[i] ^ v[i + 8], one 3-input LOP3 each)
BLAKE3_OPS = 7 * 8 * 12 + 8
BLAKE2_OPS = 10 * 8 * 12 + 8
# BLAKE2s-64 of the empty message as (lo, hi) int32 words: the digest of
# a size-0 padding row
EMPTY_BLAKE2 = tuple(int.from_bytes(hashlib.blake2s(b"", digest_size=8)
                                    .digest()[4 * k:4 * k + 4], "little",
                                    signed=True) for k in (0, 1))
# ALU operations per scanned byte: the rolling update h' = rotl(h, 1) ^
# T16[out] ^ T[in] (a rotate and a 3-input xor, LOP3; the outgoing byte's
# rotate is folded into the table T16 = rotl(T, 48)) and the candidate
# test without a division (one IMAD, n = (h + 1) * d0^-1, and half of a
# 3-input min over the positions' n; an even d adds a rotate of n, and
# 4.5 operations a byte would still leave the bound to the bytes); the
# table lookups are shared-memory loads, not ALU operations
SCAN_OPS = 3.5
SECTOR = 32             # bytes of the least read of global memory


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, int_ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes the
    function must move over HBM and its integer operations over the
    card's int32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def walk_bytes(lens, min1, min2, out) -> int:
    """Least bytes of the walk: the lengths, min1 and the output in full;
    min2 only in the 32-byte sectors of the segments whose min1 is a
    candidate and cnt only in those whose min2 is, the only ones whose
    values the walk's result depends on."""
    import torch

    from longtail_tpu_torch.parallel.stage1 import BIG

    def sectors(mask) -> int:
        first = torch.nonzero(mask).flatten() * 4 // SECTOR
        return SECTOR * int(torch.unique(first).numel())

    return (nbytes(lens, min1, out) + sectors(min1 != BIG)
            + sectors(min2 != BIG))


def structured_piece(rng, n_bytes: int) -> np.ndarray:
    """bench.py's structured mix, without jax: of every 8 MiB, 2/8
    short-period data (4.25 KiB tiles, text-like), 1/8 zeros, 2/8 24 KiB
    tile repeats and 3/8 noise."""
    R = max(-(-n_bytes // 128), 2048)
    r8 = R // 8
    base = rng.integers(0, 256, (3 * r8, 128), dtype=np.uint8)
    text = np.tile(base[:34], (2 * r8 // 34 + 1, 1))[: 2 * r8]
    zeros = np.zeros((r8, 128), np.uint8)
    tiled = np.tile(base[34:226], (2 * r8 // 192 + 1, 1))[: 2 * r8]
    return np.concatenate([text, zeros, tiled, base]).reshape(-1)[:n_bytes]


def structured(rng, n_bytes: int) -> np.ndarray:
    piece = 8 << 20
    return np.concatenate(
        [structured_piece(rng, min(piece, n_bytes - o))
         for o in range(0, n_bytes, piece)] or [np.zeros(0, np.uint8)])


def make_tree(root: str, total: int, seed: int) -> int:
    """Asset tree of ~total bytes: multi-part files with ragged last parts,
    one file of exactly 32 MiB, one duplicate file, ~40 small files (host
    path), one empty file, nested directories.  Returns bytes written."""
    rng = np.random.default_rng(seed)
    mib = 1 << 20
    small_sizes = rng.integers(1 << 10, 400 << 10, 40)
    exact = min(32 * mib, max(total // 8, mib))
    big_each = max((total - exact - int(small_sizes.sum())) // 6, mib)
    files = {}
    for i in range(5):
        ragged = big_each - (i * 1234567 + 4321) % (7 * mib)
        files[f"content/level{i % 2}/pak_{i}.bin"] = max(ragged, mib + 1)
    files["content/exact_32mib.bin"] = exact
    for k, n in enumerate(small_sizes):
        files[f"content/small/d{k % 4}/s{k:02d}.dat"] = int(n)
    written = 0
    for rel, n in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        structured(rng, n).tofile(path)
        written += n
    dup = os.path.join(root, "content/copies/deep/pak_0_copy.bin")
    os.makedirs(os.path.dirname(dup), exist_ok=True)
    shutil.copyfile(os.path.join(root, "content/level0/pak_0.bin"), dup)
    written += files["content/level0/pak_0.bin"]
    open(os.path.join(root, "content/empty.txt"), "wb").close()
    os.makedirs(os.path.join(root, "content/empty_dir"), exist_ok=True)
    return written


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean CUDA-event time of fn() over reps runs, after one warm-up
    (warmup=False for a plain version that takes seconds)."""
    import torch

    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spin_ms(fn, reps: int) -> float:
    """Mean device time of fn() (one asynchronous launch) by CUDA events
    around reps calls queued behind a spin kernel that outlasts their
    host submission, so the events see the launches back to back.  The
    spin starts at 4x the submission's host time and grows until the
    start event is still pending when the last call has been queued."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int(max(time.perf_counter() - t0, 1e-3) * 4 * CLOCK_HZ)
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the spin never outlasted the host's submission")


def device_ms(fn, reps: int, kernels) -> float:
    """Mean device time per call of fn() of the CUDA kernels whose names
    hold `kernels` (a name fragment, or a tuple of fragments for a call
    that launches several kernels: the sum of each one's mean per
    launch), under torch.profiler over reps calls of fn() after one
    warm-up: the kernels' own time, without the wrapper's host
    submission, which back-to-back CUDA events also see when the kernels
    are shorter than it.  Each mean is over the launches the profiler
    recorded, which may be fewer than reps.  The profiler's CUDA tracing
    sometimes records no kernel at all for the rest of the process: after
    three sessions that missed a fragment, the time of the whole call is
    taken by spin_ms instead, and a line says so."""
    import torch

    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        means = []
        for kernel in kernels:
            hits = [e for e in prof.key_averages() if kernel in e.key]
            seen = sum(e.count for e in hits)
            if seen:
                means.append(sum(e.device_time_total for e in hits) / 1e3
                             / seen)
        if len(means) == len(kernels):
            return sum(means)
    ms = spin_ms(fn, reps)
    log(f"{'+'.join(kernels)}: the profiler saw no launch in 3 sessions; "
        f"{ms:.4f} ms of device time by CUDA events behind a spin")
    return ms


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired int tensors (0 when equal)."""
    import torch

    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def hufpack_cases(rng, dev):
    """The frame pack's inputs (entropy_kernel.frame_inputs) at the main
    path's shapes: every Huffman section of the zstd frame of an 8 MiB
    block of the structured data, as the device tier plans it (its
    sequences from the anchors, device_entropy.huffman_jobs); the old
    single-section cases, the four streams of its 128 KiB zstd block with
    the most literals (32768 a stream) and a short single-stream section;
    and a frame of a skewed distribution (1-bit and 11-bit codes) beside
    a one-literal stream.  Returns [(name, longest code, (S, n_pad) rows
    or None, [lits, streams, tables] on dev, n_words)]."""
    import torch

    from longtail_tpu_torch.ops import (
        device_entropy,
        entropy_kernel,
        zstd_device,
        zstd_frame,
    )
    from longtail_tpu_torch.parallel.device_match import fast_block_anchors

    src = structured(rng, 8 << 20).tobytes()
    words = torch.from_numpy(np.frombuffer(src, np.int32).copy()).to(dev)
    (apos, aref), = fast_block_anchors(
        words, len(src) // 4, max_offset_words=len(src) // 4,
        suppress_sampled_chains=False)
    seqs = zstd_device.sequences_from_anchors(src, apos, aref)
    sections = [lits for _, _, lits in
                device_entropy.literal_sections(src, seqs)]
    _, _, frame = device_entropy.huffman_jobs(sections, dev)
    big = np.frombuffer(max(sections, key=len), np.uint8)
    # byte 0 12000 times, 20 bytes 100 times, the rest once: 1-bit and
    # 11-bit codes
    skew = rng.permutation(np.repeat(np.arange(256), np.r_[
        [12000], np.full(20, 100), np.ones(235, np.int64)])).astype(np.uint8)

    def job(arr):
        _, cv, cl = zstd_frame.build_huffman(
            np.bincount(arr, minlength=256).tolist())
        if len(arr) > 1023:
            seg = (len(arr) + 3) // 4
            parts = [arr[i * seg:(i + 1) * seg] for i in range(4)]
        else:
            parts = [arr]
        return parts, entropy_kernel.pack_code_table(cv, cl)

    cases = []
    for name, jobs, rows in (
            (f"8 MiB frame ({len(sections)} sections)", frame, False),
            ("128 KiB block", [job(big)], True),
            ("short section", [job(big[:700])], True),
            ("skewed frame", [job(skew), ([big[:1]], job(big)[1])], False)):
        *ins, n_words = entropy_kernel.frame_inputs(jobs)
        longest = max(int(t >> 16) for _, tab in jobs for t in tab)
        row_ins = None
        if rows:            # the (S, n_pad) interface on the same streams
            parts, tab = jobs[0]
            n_pad = 1 << max(8, (max(len(p) for p in parts) - 1).bit_length())
            lits = np.zeros((len(parts), n_pad), np.uint8)
            for i, p in enumerate(parts):
                lits[i, :len(p)] = p
            row_ins = [torch.from_numpy(x).to(dev) for x in (
                lits, np.array([len(p) for p in parts], np.int32), tab)]
        cases.append((name, longest, row_ins,
                      [torch.from_numpy(x).to(dev) for x in ins], n_words))
    if not frame or max(c[1] for c in cases) != zstd_frame.MAX_HUF_BITS:
        raise AssertionError("hufpack cases miss a branch")
    return cases


def hufpack_rows_cases(rng, dev):
    """The (S, n_pad) interface's rows, on dev: device_entropy's 128 rows
    of 128 KiB (bench_torch.literal_rows, 4 pieces a row), 2 ragged rows
    of 1 MiB (32 pieces a row) and one row of 2 MiB (64 pieces) of
    1-bit and 11-bit codes; 1 MiB rows, one whose last non-empty piece
    holds 3 literals (under 32 bits), one of n_lit 0 and one of 5 whole
    pieces; rows of one piece and of one piece + 16; and 0-bit codes, so
    that four pieces' bits meet in one word.  Returns [(name, [lits,
    n_lit, table])]."""
    import torch

    import bench_torch as bt
    from longtail_tpu_torch.ops import entropy_kernel, zstd_frame

    L = entropy_kernel.MAX_STREAM_LITS
    S, n_pad = bt.ENTROPY_STREAMS, bt.ENTROPY_STREAM_BYTES
    lits, table = bt.literal_rows(bt.literal_stream(), S, n_pad)
    cases = [(f"device_entropy's {S} x {n_pad >> 10} KiB",
              (lits, np.full((S,), n_pad, np.int32), table))]
    # byte 0 12000 times, 20 bytes 100 times, the rest once a tile
    tile = np.repeat(np.arange(256), np.r_[[12000], np.full(20, 100),
                                           np.ones(235, np.int64)])

    def skewed(name, n_pad, n_lit):
        n_lit = np.array(n_lit, np.int32)
        lits = np.stack([np.resize(rng.permutation(tile), n_pad)
                         for _ in n_lit]).astype(np.uint8)
        _, cv, cl = zstd_frame.build_huffman(
            np.bincount(lits.reshape(-1), minlength=256).tolist())
        if max(cl) != zstd_frame.MAX_HUF_BITS or \
                min(c for c in cl if c) != 1:
            raise AssertionError(f"{name}: no 1-bit or 11-bit codes")
        for i, n in enumerate(n_lit):
            lits[i, n:] = 0
        cases.append((name, (lits, n_lit,
                             entropy_kernel.pack_code_table(cv, cl))))
        return lits, n_lit, cl

    skewed("2 ragged x 1 MiB, 1-bit and 11-bit codes", 1 << 20,
           [(1 << 20) - 5, 300001])
    skewed("one 2 MiB row", 2 << 20, [2 << 20])
    lits, n_lit, cl = skewed("ragged 1 MiB rows: a last piece of 3 "
                             "literals, n_lit 0, 5 pieces", 1 << 20,
                             [20 * L + 3, 0, 5 * L])
    if not 0 < sum(cl[b] for b in lits[0, 20 * L:20 * L + 3]) < 32:
        raise AssertionError("the ragged row's last piece holds 32 bits")
    skewed("one piece", L, [L, 0, 3, L - 1])
    skewed("one piece + 16", L + 16, [L + 16, 0, L + 3, 16])
    # 0-bit codes: bits only in a row's first and last pieces, all in
    # word 0, and a row of no bits
    lits = np.zeros((3, 4 * L), np.uint8)
    lits[:, :4] = rng.integers(1, 4, (3, 4))
    lits[:2, 3 * L:3 * L + 5] = rng.integers(1, 4, (2, 5))
    lits[2] = 0
    cases.append(("0-bit pieces", (lits, np.array(
        [3 * L + 5, 4 * L, 2 * L], np.int32), entropy_kernel.pack_code_table(
            [0, 0, 2, 3], [0, 1, 2, 2]))))
    return [(name, [torch.from_numpy(np.array(x)).to(dev) for x in arrs])
            for name, arrs in cases]


def ops_per_call(fn, reps: int = 5) -> dict:
    """{CUDA op name: (launches a call, mean device us)} of fn() under
    torch.profiler (empty when the profiler records nothing)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / reps, e.device_time_total / e.count)
            for e in prof.key_averages()
            if e.count and e.device_time_total > 0}


def cut_c_pad(plan, c_pad: int):
    """plan with its c_pad cut to c_pad: the walk's truncation case."""
    import dataclasses

    from longtail_tpu_torch.parallel import stage1

    @dataclasses.dataclass(frozen=True)
    class Cut(stage1.Stage1Plan):
        @property
        def c_pad(self):
            return c_pad

    return Cut(plan.cfg, plan.lanes, plan.part_bytes)


def periodic_tile(rng, dev, cfg, table, period: int) -> np.ndarray:
    """Random bytes of one period whose repetition holds a cut candidate
    in every period (a few dozen draws at the default discriminator)."""
    import torch

    from longtail_tpu_torch.parallel import stage1

    plan = stage1.Stage1Plan(cfg, 1, stage1.SCAN_TILE)
    lens = torch.tensor([plan.part_bytes], dtype=torch.int32, device=dev)
    while True:
        tile = rng.integers(0, 256, period, dtype=np.uint8)
        data = torch.from_numpy(np.tile(tile, plan.part_bytes // period))
        if int(stage1.scan(data.to(dev), lens, table, plan)[2].sum()):
            return tile


def walk_cases(rng, dev, table) -> int:
    """The walk kernel against suffix_min + walk_plain on adversarial
    summaries, each from the scan of data made from rng, each checked to
    reach the branch it exists for: a part of zeros (forced cuts only, in
    shared memory), dense candidates with ambiguous lanes (a small
    discriminator: parts past WALK_CAP states, on global scratch),
    lengths 0, below min_size, ragged and whole, 64 lanes of 1 MiB, the
    cut list truncated at c_pad (after candidate and forced cuts), and
    2 x 32 MiB of content with a 256-byte period (two candidates in every
    segment: the most states a part can hold, on global scratch).
    Returns the largest max_abs_err."""
    import torch

    from longtail_tpu_torch.parallel import stage1
    from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig

    mib = 1 << 20
    cfg = ChunkerConfig.from_target(32768)
    dense = ChunkerConfig(48, 64, 256)
    truncated = structured(rng, 4 * mib)
    truncated[2 * mib:3 * mib] = 0
    tile = periodic_tile(rng, dev, cfg, table, 256)
    cases = (  # name, config, lanes, part bytes, data, lengths, c_pad
        ("zeros", cfg, 2, 32 * mib, np.zeros(64 * mib, np.uint8),
         [32 * mib, 32 * mib - 4096], None),
        ("dense, ambiguous", dense, 2, mib,
         rng.integers(0, 256, 2 * mib, dtype=np.uint8), [mib, mib - 777],
         None),
        ("lengths 0, < min, ragged, whole", cfg, 4, mib,
         structured(rng, 4 * mib), [0, cfg.min_size - 1, mib - 4097, mib],
         None),
        ("64 lanes x 1 MiB", cfg, 64, mib, structured(rng, 64 * mib),
         [mib] * 63 + [mib // 3], None),
        ("c_pad 8", cfg, 4, mib, truncated, [mib, mib - 1, mib, 100], 8),
        ("256-byte period", cfg, 2, 32 * mib,
         np.tile(tile, 64 * mib // len(tile)), [32 * mib] * 2, None),
    )
    worst = 0
    for name, c, lanes, part, data, lengths, c_pad in cases:
        plan = stage1.Stage1Plan(c, lanes, part)
        if c_pad is not None:
            plan = cut_c_pad(plan, c_pad)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for b, n in enumerate(lengths):
            data[b * part + n:(b + 1) * part] = 0
        batch = torch.from_numpy(data).to(dev)
        tab = table if c is cfg else stage1.hash_table(dev)
        summ = stage1.scan(batch, lens, tab, plan)
        got = stage1.walk(lens, *summ, plan)
        want = stage1.walk_plain(lens, *summ,
                                 stage1.suffix_min(summ[0], plan), plan)
        err = max_abs_err([got], [want])
        out = got.cpu().numpy()
        n, amb = out[:, plan.c_pad], out[:, plan.c_pad + 1]
        # the kernel's states per part: 0, then every min1 and min2 < BIG
        states = 1 + sum((t.view(lanes, -1) != stage1.BIG).sum(1)
                         for t in summ[:2]).cpu().numpy()
        scratch = states + 1 > stage1.WALK_CAP
        ms = cuda_ms(lambda: stage1.walk(lens, *summ, plan), 5)
        log(f"walk {name}: {lanes} x {part >> 10} KiB, max_abs_err {err}, "
            f"{int(n.sum())} cuts, {int(amb.sum())} ambiguous lanes, "
            f"states per part up to {int(states.max())} ({int(scratch.sum())}"
            f" parts on global scratch), {ms:.4f} ms by events")
        mx = c.max_size
        branch = {
            "zeros": not scratch.any() and not amb.any() and all(
                np.array_equal(out[b, :n[b]], np.minimum(
                    np.arange(1, -(-L // mx) + 1) * mx, L))
                for b, L in enumerate(lengths)),
            "dense, ambiguous": amb.any() and scratch.any(),
            "lengths 0, < min, ragged, whole": not scratch.any()
                and n[0] == 0 and n[1] == 1 and out[1, 0] == lengths[1],
            "64 lanes x 1 MiB": not scratch.any(),
            "c_pad 8": n.tolist() == [8, 8, 8, 1] and np.array_equal(
                out[2, :8], np.arange(1, 9) * mx),
            "256-byte period": scratch.all()
                and (states >= 2 * plan.segments_per_part).all(),
        }[name]
        if not branch:
            raise AssertionError(f"walk case {name!r} missed its branch")
        worst = max(worst, err)
    return worst


def scan_cases(rng, dev, table, cfg) -> int:
    """The scan kernel against scan_plain (bins included) at the smallest
    Z (128, target 1 KiB: another discriminator, two segments a thread)
    on 4 x 1 MiB of lengths whole, ragged, 4097 and 0, on 3 parts of 20
    KiB (a partial last block), and at an odd discriminator (target 128
    KiB: d 49535, the kernel's filter without a rotate, Z 2048); each
    checked to reach its branch.  Returns the largest max_abs_err."""
    import torch

    from longtail_tpu_torch.parallel import stage1
    from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig

    mib = 1 << 20
    small = ChunkerConfig.from_target(1024)
    cases = (("Z 128", small, 4, mib, structured(rng, 4 * mib),
              [mib, mib - 1, 4097, 0]),
             ("partial block", cfg, 3, 20480,
              rng.integers(0, 256, 3 * 20480, dtype=np.uint8),
              [20480, 100, 9999]),
             ("odd d", ChunkerConfig.from_target(128 << 10), 2, 2 * mib,
              structured(rng, 4 * mib), [2 * mib, mib + 12345]))
    worst = 0
    for name, c, lanes, part, data, lengths in cases:
        plan = stage1.Stage1Plan(c, lanes, part)
        for b, n in enumerate(lengths):
            data[b * part + n:(b + 1) * part] = 0
        batch = torch.from_numpy(data).to(dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = stage1.scan(batch, lens, table, plan, with_bins=True)
        err = max_abs_err(got, stage1.scan_plain(batch, lens, table, plan,
                                                 with_bins=True))
        cands = int(got[2].sum())
        log(f"scan {name}: {lanes} x {part} bytes, Z {plan.z}, d "
            f"{c.discriminator}, {cands} candidates, max_abs_err {err}")
        branch = {"Z 128": plan.z == 128 and
                  c.discriminator != cfg.discriminator and cands > 0,
                  "partial block": len(data) % (256 * 256) != 0
                  and cands > 0,
                  "odd d": c.discriminator % 2 == 1 and cands > 0}[name]
        if not branch:
            raise AssertionError(f"scan case {name!r} missed its branch")
        worst = max(worst, err)
    return worst


def blake3_cases(rng, dev) -> int:
    """The BLAKE3 kernel against hash_chunks_batch on a batch of chunks
    it must get right in one call: odd starts, sizes 0, 1, 63, 64, 1023,
    1024, 1025, the default geometry's largest chunk (64 KiB), a chunk of
    MAX_LEAVES leaves (a block's threads loop over its leaves), size 0 at
    the batch's end and a chunk ending on its last byte; each checked to
    be there.  Returns max_abs_err."""
    import torch

    from longtail_tpu_torch.ops import blake3, blake3_kernel

    n = (1 << 20) + (192 << 10)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    sizes = np.array([0, 1, 63, 64, 1023, 1024, 1025, 65536, 4097, 33 << 10,
                      0, 777, blake3.MAX_LEAVES * 1024], np.int64)
    starts = np.array([5, 17, 1001, 3, 4095, 40961, 77, 70001, 1, 9, n,
                       n - 777, 192 << 10], np.int64)
    extra = rng.integers(0, 9000, 40)
    sizes = np.concatenate([sizes, extra])
    starts = np.concatenate([starts, [rng.integers(0, n - s + 1)
                                      for s in extra]])
    plan = blake3.plan_blocks(blake3.leaves_of(sizes))
    reach = ((sizes == 0).any() and (starts % 4 != 0).any()
             and (starts + sizes == n).any() and (starts == n).any()
             and blake3.leaves_of(sizes).max() == blake3.MAX_LEAVES)
    if not reach:
        raise AssertionError("BLAKE3 cases miss a branch")
    args = [torch.from_numpy(x).to(dev) for x in (
        data, starts.astype(np.int32), sizes.astype(np.int32), plan)]
    err = max_abs_err(blake3_kernel.hash_chunks_device(*args),
                      blake3.hash_chunks_batch(*args[:3]))
    log(f"blake3 adversarial: {len(sizes)} chunks in {len(plan) - 1} "
        f"blocks, max_abs_err {err}")
    return err


def blake2_cases(rng, dev) -> int:
    """The BLAKE2 batch kernel against hash_chunks_batch on chunks it must
    get right in one call: odd starts, sizes 0, 1, 63, 64, 65, 4 KiB - 1
    and 64 KiB, size 0 at the batch's end, a chunk ending on its last
    byte, in plan_order; each checked to be there.  Returns
    max_abs_err."""
    import torch

    from longtail_tpu_torch.ops import blake2, blake2_kernel

    n = 1 << 20
    data = rng.integers(0, 256, n, dtype=np.uint8)
    sizes = np.array([0, 1, 63, 64, 65, 4095, 65536, 0, 777, 128, 4097],
                     np.int64)
    starts = np.array([5, 17, 1001, 3, 4093, 40961, 70001, n, n - 777, 64,
                       1], np.int64)
    extra = rng.integers(0, 66000, 60)
    sizes = np.concatenate([sizes, extra])
    starts = np.concatenate([starts, [rng.integers(0, n - s + 1)
                                      for s in extra]])
    reach = ((sizes == 0).any() and (starts % 4 != 0).any()
             and (starts + sizes == n).any() and (starts == n).any()
             and {1, 63, 64, 65, 4095, 65536} <= set(sizes.tolist()))
    if not reach:
        raise AssertionError("BLAKE2 cases miss a branch")
    args = [torch.from_numpy(x).to(dev) for x in (
        data, starts.astype(np.int32), sizes.astype(np.int32),
        blake2.plan_order(sizes))]
    err = max_abs_err(blake2_kernel.hash_chunks_device(*args),
                      blake2.hash_chunks_batch(*args[:3]))
    log(f"blake2 adversarial: {len(sizes)} chunks, max_abs_err {err}")
    return err


def check_kernels(seed: int) -> list:
    """Phase 3: each kernel against its plain version on the card."""
    import torch

    from longtail_tpu_torch.ops import (
        blake2,
        blake2_kernel,
        blake3,
        blake3_kernel,
        entropy_kernel,
        pack,
    )
    from longtail_tpu_torch.parallel import stage1
    from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig

    dev = torch.device("cuda")
    cfg = ChunkerConfig.from_target(32768)
    P = 32768 * 1024
    plan = stage1.Stage1Plan(cfg, 2, P)
    rng = np.random.default_rng(seed)
    flat = structured(rng, 2 * P)
    lengths = np.array([P, P - 12345 * 7], np.int32)
    flat[P + lengths[1]:] = 0
    batch = torch.from_numpy(flat).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    table = stage1.hash_table(dev)
    rows = []

    def row(name, src, rep, err, ms, plain_ms, dev_ms, bnd):
        log(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms by CUDA events "
            f"around the wrapper, {dev_ms:.4f} ms of device time "
            f"(plain PyTorch {plain_ms:.4f} ms; bound {bnd[0]:.6f} ms by "
            f"{bnd[1]})")
        if err != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version (max_abs_err {err})")
        # no single PyTorch call computes any of the six functions
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "device_ms": dev_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": None})

    # scan, with the bins output compared too; timed as the upsync path
    # runs it (no bins), the bins variant logged beside it
    got = stage1.scan(batch, lens, table, plan, with_bins=True)
    want = stage1.scan_plain(batch, lens, table, plan, with_bins=True)
    bins_ms = cuda_ms(lambda: stage1.scan(batch, lens, table, plan,
                                          with_bins=True), 20)
    log(f"scan with bins: {bins_ms:.4f} ms, {got[3].numel()} bins")
    serr = max(max_abs_err(got, want), scan_cases(rng, dev, table, cfg))
    # the same batch at the 1 KiB target: Z 128 and d 384 = 3 * 2^7, a
    # candidate every ~384 bytes
    small = stage1.Stage1Plan(ChunkerConfig.from_target(1024), 2, P)
    got_small = stage1.scan(batch, lens, table, small)
    serr = max(serr, max_abs_err(got_small, stage1.scan_plain(
        batch, lens, table, small)))
    small_ms = device_ms(lambda: stage1.scan(batch, lens, table, small), 20,
                         "scan_kernel")
    log(f"scan at Z 128, d {small.cfg.discriminator}: "
        f"{int(got_small[2].sum())} candidates, {small_ms:.4f} ms of device "
        f"time (the default's Z {plan.z}, d {cfg.discriminator}: the scan "
        f"row)")
    row("scan", stage1.SOURCE, stage1.SCAN_REPLACES, serr,
        cuda_ms(lambda: stage1.scan(batch, lens, table, plan), 20),
        cuda_ms(lambda: stage1.scan_plain(batch, lens, table, plan), 2),
        device_ms(lambda: stage1.scan(batch, lens, table, plan), 20,
                  "scan_kernel"),
        bound(nbytes(batch, lens, table, *got[:3]),
              SCAN_OPS * batch.numel()))
    got = got[:3]

    # the walk needs no suffix-min; its plain version walks with one
    wout = stage1.walk(lens, *got, plan)
    wplain = stage1.walk_plain(lens, *got, stage1.suffix_min(got[0], plan),
                               plan)
    werr = max(max_abs_err([wout], [wplain]), walk_cases(rng, dev, table))
    row("walk", stage1.SOURCE, stage1.WALK_REPLACES, werr,
        cuda_ms(lambda: stage1.walk(lens, *got, plan), 20),
        cuda_ms(lambda: stage1.walk_plain(
            lens, *got, stage1.suffix_min(got[0], plan), plan), 1),
        device_ms(lambda: stage1.walk(lens, *got, plan), 20, "walk_kernel"),
        bound(walk_bytes(lens, got[0], got[1], wout), 0))
    log(f"stage 1 per 64 MiB batch (scan + walk): "
        f"{cuda_ms(lambda: stage1.stage1(batch, lens, table, plan), 20):.4f}"
        f" ms by events; suffix_min, which the card's walk no longer "
        f"needs: {cuda_ms(lambda: stage1.suffix_min(got[0], plan), 20):.4f}"
        f" ms")

    sizes, n, amb = stage1.unpack_walk(wout.cpu().numpy(), plan)
    log(f"batch: {n.tolist()} chunks per part, ambiguous {amb.tolist()}")
    all_st, all_sz = [], []
    for b in range(plan.lanes):
        sz = sizes[b, :n[b]].astype(np.int64)
        all_st.append(b * P + np.concatenate([[0], np.cumsum(sz)[:-1]]))
        all_sz.append(sz)
    st_all, sz_all = np.concatenate(all_st), np.concatenate(all_sz)

    # BLAKE3: every chunk of the batch in one launch, read from the batch;
    # its bytes are the chunk bytes once, starts, sizes, plan and output
    st_t = torch.from_numpy(st_all.astype(np.int32)).to(dev)
    sz_t = torch.from_numpy(sz_all.astype(np.int32)).to(dev)
    plan_t = torch.from_numpy(
        blake3.plan_blocks(blake3.leaves_of(sz_all))).to(dev)
    b3 = (batch, st_t, sz_t, plan_t)
    b3err = max(max_abs_err(blake3_kernel.hash_chunks_device(*b3),
                            blake3.hash_chunks_batch(*b3[:3])),
                blake3_cases(rng, dev))
    b3_blocks = np.maximum(-(-sz_all // 64), 1)
    b3_leaves = blake3.leaves_of(sz_all)
    b3_ms = cuda_ms(lambda: blake3_kernel.hash_chunks_device(*b3), 20)
    b3_dev = device_ms(lambda: blake3_kernel.hash_chunks_device(*b3), 20,
                       "blake3_kernel")
    log(f"blake3: {len(sz_all)} chunks in {plan_t.numel() - 1} blocks, "
        f"one launch: {b3_dev:.4f} ms of device time against the packed-"
        f"row design's pack + BLAKE3 per batch (0.0784 + 0.1079 = 0.1863 "
        f"ms on an H100 at 700 W)")
    row("blake3", blake3_kernel.SOURCE, blake3_kernel.REPLACES, b3err,
        b3_ms, cuda_ms(lambda: blake3.hash_chunks_batch(*b3[:3]), 1,
                       warmup=False), b3_dev,
        bound(int(sz_all.sum()) + nbytes(st_t, sz_t, plan_t) + 8 * len(sz_all),
              BLAKE3_OPS * int((b3_blocks + b3_leaves - 1).sum())))

    # BLAKE2: every chunk of the batch in one launch, in plan_order, read
    # from the batch; its bytes are the chunk bytes once, starts, sizes,
    # order and output
    b2_order = torch.from_numpy(blake2.plan_order(sz_all)).to(dev)
    b2 = (batch, st_t, sz_t, b2_order)
    b2_out = []         # the plain version takes ~a minute: timed once
    b2_plain_ms = cuda_ms(lambda: b2_out.append(blake2.hash_chunks_batch(
        *b2[:3])), 1, warmup=False)
    b2_plain = b2_out[0]
    b2err = max(max_abs_err(blake2_kernel.hash_chunks_device(*b2), b2_plain),
                blake2_cases(rng, dev))
    b2_blocks = blake2.blocks_of(sz_all)
    b2_ms = cuda_ms(lambda: blake2_kernel.hash_chunks_device(*b2), 10)
    b2_dev = device_ms(lambda: blake2_kernel.hash_chunks_device(*b2), 10,
                       "blake2_kernel")
    # the threads in plan_order and in chunk order, the two in turn for 3
    # rounds, by CUDA events (the kernel is long beside its submission)
    orders = {"plan_order": b2_order, "chunk order": torch.arange(
        len(sz_all), dtype=torch.int32, device=dev)}
    b2_times = {k: [] for k in orders}
    for _ in range(3):
        for k, order in orders.items():
            b2_times[k].append(cuda_ms(
                lambda: blake2_kernel.hash_chunks_device(*b2[:3], order), 10))
    log(f"blake2: {len(sz_all)} chunks in one launch: {b2_dev:.4f} ms of "
        f"device time against the size-class design's 2.3375 ms (4 pack + "
        f"4 BLAKE2 launches per batch, on an H100 at 700 W); ms by events "
        f"of 3 rounds in turn: " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)}"
            for k, v in b2_times.items()))
    # a model, not a measurement: one thread per chunk, one warp issuing
    # one integer instruction every other cycle (16 INT32 lanes a
    # sub-partition)
    log(f"blake2 chain model: the longest chunk's "
        f"{int(b2_blocks.max())} compressions x {BLAKE2_OPS} instructions "
        f"x 2 cycles at {CLOCK_HZ / 1e9} GHz = "
        f"{int(b2_blocks.max()) * BLAKE2_OPS * 2 / CLOCK_HZ * 1e3:.4f} ms")

    # pack per size class of the batch's chunks plus size-0 padding rows
    # (no upsync path runs it); both hashes' row interfaces on its rows,
    # BLAKE2's held to the batch's plain digests of the same chunks
    cap, floor = pack.pow2_cap(cfg.padded_chunk), pack.class_floor(cfg)
    padded = pack.pow2_padded(sz_all, cap, floor)
    perr, rerr = 0, 0
    t = {"pack": 0.0, "pack_plain": 0.0, "pack_device": 0.0}
    pack_bytes = 0
    for cls in np.unique(padded):
        idx = np.flatnonzero(padded == cls)
        tail = np.zeros(5, np.int64)                 # size-0 padding rows
        st = torch.from_numpy(np.concatenate([st_all[idx], tail])
                              .astype(np.int32)).to(dev)
        sz = torch.from_numpy(np.concatenate([sz_all[idx], tail])
                              .astype(np.int32)).to(dev)
        cls = int(cls)
        words = pack.pack(batch, st, sz, cls)
        perr = max(perr, max_abs_err(
            [words], [pack.pack_plain(batch, st, sz, cls)]))
        t["pack"] += cuda_ms(lambda: pack.pack(batch, st, sz, cls), 10)
        t["pack_plain"] += cuda_ms(
            lambda: pack.pack_plain(batch, st, sz, cls), 2)
        t["pack_device"] += device_ms(
            lambda: pack.pack(batch, st, sz, cls), 10, "pack_kernel")
        pack_bytes += int(sz.to(torch.int64).sum()) + nbytes(st, sz, words)
        rerr = max(rerr, max_abs_err(
            blake3_kernel.hash_chunks_words_device(words, sz),
            blake3.hash_chunks_words(words, sz)))
        at = torch.from_numpy(idx).to(dev)
        lo, hi = blake2_kernel.hash_chunks_words_device(words, sz)
        rerr = max(rerr, max_abs_err(
            [lo[:len(idx)], hi[:len(idx)], lo[len(idx):], hi[len(idx):]],
            [b2_plain[0][at], b2_plain[1][at]] + [torch.full_like(
                lo[len(idx):], EMPTY_BLAKE2[k]) for k in (0, 1)]))
        log(f"class {cls >> 10} KiB: {len(idx)} chunks + 5 padding rows; "
            f"pack, BLAKE3 rows and BLAKE2 rows max_abs_err {perr}, {rerr}")
    if rerr:
        raise AssertionError(f"a row interface disagrees: max_abs_err {rerr}")
    row("pack", pack.SOURCE, pack.REPLACES, perr, t["pack"],
        t["pack_plain"], t["pack_device"], bound(pack_bytes, 0))
    row("blake2", blake2_kernel.SOURCE, blake2_kernel.REPLACES, b2err,
        b2_ms, b2_plain_ms, b2_dev,
        bound(int(sz_all.sum()) + nbytes(st_t, sz_t, b2_order)
              + 8 * len(sz_all), BLAKE2_OPS * int(b2_blocks.sum())))

    # the Huffman pack, one launch per frame; the frame row is the main
    # path's shape, the other cases are checked and logged
    herr = 0
    for name, longest, row_ins, ins, n_words in hufpack_cases(rng, dev):
        out = entropy_kernel.hufpack_frame(*ins, n_words)
        e = max_abs_err(out, entropy_kernel.hufpack_frame_plain(
            *ins, n_words))
        if row_ins is not None:
            e = max(e, max_abs_err(entropy_kernel.hufpack(*row_ins),
                                   entropy_kernel.hufpack_plain(*row_ins)))
        herr = max(herr, e)
        ms = cuda_ms(lambda: entropy_kernel.hufpack_frame(*ins, n_words), 20)
        dms = device_ms(lambda: entropy_kernel.hufpack_frame(*ins, n_words),
                        20, "hufpack_kernel")
        log(f"hufpack {name}: {ins[1].shape[0]} streams, {ins[0].numel()} "
            f"literal bytes, longest code {longest} bits, max_abs_err {e}, "
            f"{ms:.4f} ms by events, {dms:.4f} ms of device time")
        if name.startswith("8 MiB frame"):
            frame = (ms, cuda_ms(lambda: entropy_kernel.hufpack_frame_plain(
                *ins, n_words), 3), dms, nbytes(*ins, *out))
    # the (S, n_pad) interface: one launch of hufrows_kernel a call and no
    # other CUDA op (no memset, no piece list), against the contract and
    # the plain version of its kernel
    for name, args in hufpack_rows_cases(rng, dev):
        got = entropy_kernel.hufpack(*args)
        e = max(max_abs_err(got, entropy_kernel.hufpack_plain(*args)),
                max_abs_err(got, entropy_kernel.hufpack_pieces_plain(*args)))
        herr = max(herr, e)
        for _ in range(3):          # a session may miss launches
            ops = ops_per_call(lambda: entropy_kernel.hufpack(*args))
            rows_ops = sum(c for k, (c, _) in ops.items()
                           if "hufrows_kernel" in k)
            if rows_ops > 1.0 or any("hufrows_kernel" not in k
                                     for k in ops):
                raise AssertionError(f"hufpack {name}: CUDA ops a call "
                                     f"{ops}, not one hufrows_kernel")
            if rows_ops == 1.0:
                break
        else:
            raise AssertionError(f"hufpack {name}: the profiler never saw "
                                 f"one hufrows_kernel a call ({ops})")
        kms = device_ms(lambda: entropy_kernel.hufpack(*args), 20,
                        "hufrows_kernel")
        ms = cuda_ms(lambda: entropy_kernel.hufpack(*args), 20)
        plain_ms = cuda_ms(lambda: entropy_kernel.hufpack_plain(*args), 3)
        bnd = bound(nbytes(*args, *got), 0)
        log(f"hufpack rows, {name}: {args[0].shape[0]} x "
            f"{args[0].shape[1]}, {entropy_kernel.pieces_per_row(args[0].shape[1])}"
            f" pieces a row, max_abs_err {e}; one launch a call: "
            f"hufrows_kernel {kms:.4f} ms of device time, the (S, n_pad) "
            f"interface {ms:.4f} ms by events, plain {plain_ms:.4f} ms; "
            f"bound {bnd[0]:.6f} ms by {bnd[1]}")
    row("hufpack", entropy_kernel.SOURCE, entropy_kernel.REPLACES, herr,
        frame[0], frame[1], frame[2], bound(frame[3], 0))
    return rows


def same_tree(a: str, b: str) -> int:
    """Raise unless the trees under a and b hold the same files and
    directories with the same bytes; returns the file count."""
    def listing(root):
        out = set()
        for d, dirs, files in os.walk(root):
            rel = os.path.relpath(d, root)
            out.update(os.path.normpath(os.path.join(rel, x)) + "/"
                       for x in dirs)
            out.update(os.path.normpath(os.path.join(rel, x)) for x in files)
        return out
    la, lb = listing(a), listing(b)
    if la != lb:
        raise AssertionError(f"trees differ: {sorted(la ^ lb)[:10]}")
    files = [p for p in la if not p.endswith("/")]
    for p in files:
        if not filecmp.cmp(os.path.join(a, p), os.path.join(b, p),
                           shallow=False):
            raise AssertionError(f"file differs after downsync: {p}")
    return len(files)


def stored_blocks(store_dir: str):
    """(block hash, tag, raw size, compressed payload) of every block of
    an FSBlockStore directory, as the compression store wrote them."""
    import struct

    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage

    backing = FSBlockStore(FSStorage(), store_dir)
    for d, _, files in os.walk(os.path.join(store_dir, "chunks")):
        for f in sorted(files):
            if f.endswith(".lrb"):
                blk = backing.get_stored_block(int(f[2:-4], 16))
                raw, comp = struct.unpack_from("<II", blk.block_data, 0)
                yield (int(f[2:-4], 16), blk.block_index.tag, raw,
                       bytes(blk.block_data[8:8 + comp]))


def zstd_block_types(frame: bytes) -> dict:
    """Counts of the zstd blocks of a single-segment frame by type (the
    frames the device tier writes): raw, rle, compressed."""
    fcs = frame[4] >> 6
    off = 5 + (1, 2, 4, 8)[fcs]
    out = {"raw": 0, "rle": 0, "compressed": 0}
    while True:
        h = int.from_bytes(frame[off:off + 3], "little")
        kind = ("raw", "rle", "compressed")[(h >> 1) & 3]
        out[kind] += 1
        off += 3 + (1 if kind == "rle" else h >> 3)
        if h & 1:
            return out


def store_summary(store_dir: str, codec: str) -> dict:
    """Raw and stored bytes of a store, and how many blocks took each
    route: host codec (under 64 KiB) or device tier, and for zstd device
    frames their zstd blocks by type."""
    out = {"blocks": 0, "raw": 0, "stored": 0, "host_route": 0,
           "device_route": 0}
    for _, _, raw, payload in stored_blocks(store_dir):
        out["blocks"] += 1
        out["raw"] += raw
        out["stored"] += len(payload)
        if raw < (1 << 16):
            out["host_route"] += 1
            continue
        out["device_route"] += 1
        if codec == "zstd":
            for k, v in zstd_block_types(payload).items():
                out[f"zstd_{k}"] = out.get(f"zstd_{k}", 0) + v
    return out


def reset(wrappers: dict) -> None:
    for w in wrappers.values():
        w.LAUNCHES = 0


def require_launches(name: str, counts: dict, need) -> None:
    for k in need:
        if counts[k] <= 0:
            raise AssertionError(f"the {name} path never launched {k}")


def stage4(src: str, n_batches: int, wrappers: dict) -> None:
    """Stage 4 over the first batches of the tree's large files:
    DevicePartIndexer(compress=True) with plan_hash(keep_words=True) ->
    submit_compress -> collect_compress, against the same run from the
    resident words (compress=False); every 8 MiB block's anchors go
    through the host LZ4 assembler and must decode.  The launch counts
    are set to 0 before the timed compress=True batches and read after
    them: the only path that runs the scan with its bins output."""
    import torch

    from longtail_tpu_torch.ops import lz4
    from longtail_tpu_torch.parallel import device_match
    from longtail_tpu_torch.parallel.pipeline import DevicePartIndexer

    dev = torch.device("cuda")
    ix = {c: DevicePartIndexer(32768, dev, compress=c) for c in (True, False)}
    P = ix[True].part_bytes
    parts = []
    for d, _, files in sorted(os.walk(src)):
        for f in sorted(files):
            data = np.fromfile(os.path.join(d, f), np.uint8)
            parts += [data[o:o + P] for o in range(0, len(data), P)
                      if len(data) > P]
    B = ix[True].lanes
    batches = [parts[i:i + B] for i in range(0, len(parts), B)]
    batches = [b for b in batches if len(b) == B][:n_batches + 1]
    if len(batches) < 2:
        raise AssertionError(f"stage 4: under 2 full batches of {B} parts")

    def run(indexer, batch):
        entry = indexer.plan_hash(indexer.submit_host(list(enumerate(batch))),
                                  keep_words=True)
        handle = indexer.submit_compress(entry)
        list(indexer.retire(entry))
        return indexer.collect_compress(handle)

    run(ix[True], batches[0])                       # warm-up
    torch.cuda.synchronize()
    n_anchors = 0
    reset(wrappers)
    t0 = time.perf_counter()
    got = [run(ix[True], b) for b in batches[1:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: w.LAUNCHES for k, w in wrappers.items()}
    n_bytes = sum(len(p) for b in batches[1:] for p in b)
    log(f"stage 4: {len(batches) - 1} batches of {B} x {P >> 20} MiB, "
        f"chunk+hash+compress anchors {wall:.3f} s = "
        f"{n_bytes / wall / 1e9:.3f} GB/s (one batch at a time); "
        f"launches {counts}")
    require_launches("stage-4", counts, ("scan", "walk", "blake3"))
    if counts["pack"]:
        raise AssertionError("the BLAKE3 stage-4 path launched pack")
    blocks = 0
    for batch, anchors in zip(batches[1:], got):
        words = run(ix[False], batch)
        if len(words) != len(anchors):
            raise AssertionError("stage 4: block counts differ")
        flat = np.zeros(B * P, np.uint8)
        for i, p in enumerate(batch):
            flat[i * P:i * P + len(p)] = p
        blk = len(flat) // len(anchors)
        for k, ((pos, ref), (wpos, wref)) in enumerate(zip(anchors, words)):
            if not (np.array_equal(pos, wpos) and np.array_equal(ref, wref)):
                raise AssertionError("stage 4: bins anchors differ from "
                                     "words anchors")
            block = flat[k * blk:(k + 1) * blk].tobytes()
            keep = pos < len(block)
            out = lz4.assemble_anchors(block, pos[keep], ref[keep])
            if lz4.decompress(out, len(block)) != block:
                raise AssertionError("stage 4: an LZ4 block does not decode")
            blocks += 1
            n_anchors += len(pos)
    log(f"stage 4: {blocks} blocks, bins anchors == words anchors, "
        f"{n_anchors} anchors, every LZ4 block decodes "
        f"(anchor cap {device_match.FAST_CAP} per block)")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def lrb_set(store_dir: str) -> set:
    return {f for _, _, fs in os.walk(store_dir) for f in fs
            if f.endswith(".lrb")}


def mesh_phase(src: str, total: int, tmp: str, lz4_wall: float,
               wrappers: dict, batches) -> dict:
    """Phase 7: api.upsync over two indexers on the card, LZ4 device
    codecs; its .lvi must equal phase 4's LZ4 .lvi."""
    import torch

    from longtail_tpu_torch import api
    from longtail_tpu_torch.formats import constants as C
    from longtail_tpu_torch.stores.compressblockstore import (
        CompressBlockStore,
    )
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage

    fs = FSStorage()
    store = CompressBlockStore(FSBlockStore(
        fs, os.path.join(tmp, "store_mesh")), device="cuda")
    reset(wrappers)
    batches.BATCHES = 0
    t0 = time.perf_counter()
    vi, _ = api.upsync(fs, src, store,
                       compression_tag=C.COMPRESSION_TYPE_LZ4_DEFAULT,
                       device="cuda", mesh=["cuda:0", "cuda:0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: w.LAUNCHES for k, w in wrappers.items()}
    log(f"mesh upsync (2 indexers on cuda:0, LZ4): {wall:.3f} s, "
        f"{total / wall / 1e9:.3f} GB/s (phase 4's LZ4 upsync {lz4_wall:.3f}"
        f" s, {total / lz4_wall / 1e9:.3f} GB/s); launches {counts}; "
        f"{batches.BATCHES} batches")
    require_launches("mesh", counts, ("scan", "walk", "blake3"))
    if counts["blake3"] != batches.BATCHES or counts["pack"]:
        raise AssertionError("the mesh path must launch BLAKE3 once per "
                             "batch and pack never")
    lvi = open(os.path.join(tmp, "lz4.lvi"), "rb").read()
    if vi.to_bytes() != lvi:
        raise AssertionError("mesh upsync: .lvi differs from phase 4's LZ4")
    log("mesh upsync: .lvi byte-identical to phase 4's LZ4 upsync")
    return counts


def distributed_phase(src: str, wrappers: dict) -> dict:
    """Phase 8: the all-gather dedup steps in an NCCL group of world size
    1 on the card, on one 64 MiB batch of the tree's parts, against
    DevicePartIndexer's sizes and hashes for that batch."""
    import torch
    import torch.distributed as dist

    from longtail_tpu_torch.parallel import distributed
    from longtail_tpu_torch.parallel.pipeline import DevicePartIndexer

    ix = DevicePartIndexer(32768, "cuda")
    P, B = ix.part_bytes, ix.lanes
    files = sorted((os.path.join(d, f) for d, _, fs in os.walk(src)
                    for f in fs), key=lambda p: (-os.path.getsize(p), p))
    parts = []
    for path in files[:B]:          # the first parts of the largest files
        data = np.fromfile(path, np.uint8)
        parts += [data[o:o + P] for o in range(0, len(data), P)]
    parts = parts[:B]
    want = list(ix.retire(ix.plan_hash(ix.submit_host(
        list(enumerate(parts))))))
    rows = np.zeros((B, P), np.uint8)
    lengths = np.array([len(p) for p in parts], np.int32)
    for b, p in enumerate(parts):
        rows[b, :len(p)] = p
    batch = torch.from_numpy(rows).to("cuda")
    slots = distributed.default_dedup_slots(ix.cfg, B, P)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        reset(wrappers)
        t0 = time.perf_counter()
        sizes, _, _, ulo, uhi, n, ov = distributed.sharded_chunk_step(
            batch, lengths, ix.cfg, slots)
        torch.cuda.synchronize()
        t_chunk = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, isizes, iulo, iuhi, i_n = distributed.sharded_index_step(
            batch, lengths, ix.cfg)
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t0
        counts = {k: w.LAUNCHES for k, w in wrappers.items()}
    finally:
        dist.destroy_process_group()
    uniq = np.unique(np.concatenate([h for _, _, h in want]))
    for name, s, u in (("sharded_chunk_step", sizes,
                        distributed.host_unique_hashes(ulo, uhi, n)),
                       ("sharded_index_step", isizes,
                        distributed.host_unique_hashes(iulo, iuhi, i_n))):
        s = s.cpu().numpy()
        for b, (_, sz, _) in enumerate(want):
            if not (np.array_equal(s[b, :len(sz)], sz)
                    and not s[b, len(sz):].any()):
                raise AssertionError(f"{name}: sizes of lane {b} differ")
        if not np.array_equal(u, uniq):
            raise AssertionError(f"{name}: unique set differs from "
                                 "np.unique of the indexer's hashes")
    if int(ov):
        raise AssertionError(f"sharded_chunk_step overflowed {slots} slots")
    log(f"distributed steps (NCCL, world size 1): {B} x {P >> 20} MiB, "
        f"{sum(len(s) for _, s, _ in want)} chunks, {len(uniq)} unique, "
        f"dedup slots {slots}; sharded_chunk_step {t_chunk:.3f} s, "
        f"sharded_index_step {t_index:.3f} s; sizes and unique set equal "
        f"the indexer's; launches {counts}")
    require_launches("distributed", counts, ("scan", "walk", "blake3"))
    return counts


def multihost_phase(src: str, tmp: str) -> dict:
    """Phase 9: two processes of the multihost dry run on the card, LZ4
    blocks into one store; .lvi and .lrb set against phase 4's LZ4 run,
    the sharded downsync against the tree."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"compute mode: {mode}")
    if mode.splitlines()[0] != "Default":
        raise AssertionError(f"two processes on one card need compute mode "
                             f"Default, not {mode}")
    repo = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "out_mh")
    env = dict(os.environ, PYTHONPATH=repo, LT_MH_NPROC="2",
               LT_MH_COORD=f"127.0.0.1:{free_port()}", LT_MH_SRC=src,
               LT_MH_STORE=os.path.join(tmp, "store_mh"),
               LT_MH_LVI=os.path.join(tmp, "mh.lvi"), LT_MH_OUT=out,
               LT_MH_TCS="32768", LT_MH_DEVICE="cuda")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "longtail_tpu_torch.parallel.multihost"],
        env=dict(env, LT_MH_PID=str(r)), cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost rank {r} exited {p.returncode}"
                                 f":\n{o[-3000:]}")
    counts = [json.loads(o.strip().splitlines()[-1])["launches"]
              for o in outs]
    log(f"two processes on cuda:0 (gloo host arrays, LZ4): wall "
        f"{wall:.3f} s including both processes' start; launches per rank "
        f"{counts}")
    for c in counts:
        require_launches("multihost", c, ("scan", "walk", "blake3"))
    lvi = open(os.path.join(tmp, "lz4.lvi"), "rb").read()
    if open(os.path.join(tmp, "mh.lvi"), "rb").read() != lvi:
        raise AssertionError("multihost: .lvi differs from phase 4's LZ4")
    blocks = lrb_set(os.path.join(tmp, "store_mh"))
    if blocks != lrb_set(os.path.join(tmp, "store_lz4")):
        raise AssertionError("multihost: .lrb set differs from phase 4's")
    log(f"multihost: .lvi byte-identical to phase 4's LZ4, {len(blocks)} "
        f"blocks as phase 4's; sharded downsync: {same_tree(src, out)} "
        f"files byte-identical")
    shutil.rmtree(out)
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def pack_phase(src: str, tmp: str, wrappers: dict) -> tuple:
    """Phase 10: pack --device (zstd) against pack --device cpu, one
    worker each so that blocks land in the archive in order; unpack."""
    import torch

    from longtail_tpu_torch import cli

    las = {d: os.path.join(tmp, f"{d}.la") for d in ("cuda", "cpu")}
    walls = {}
    for d in ("cuda", "cpu"):
        reset(wrappers)
        t0 = time.perf_counter()
        rc = cli.main(["--workers", "1", "pack", "--source-path", src,
                       "--target-path", las[d], "--device", d])
        torch.cuda.synchronize()
        walls[d] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"pack --device {d} exited {rc}")
        if d == "cuda":
            counts = {k: w.LAUNCHES for k, w in wrappers.items()}
    if open(las["cuda"], "rb").read() != open(las["cpu"], "rb").read():
        raise AssertionError("pack --device: .la differs from --device cpu")
    out = os.path.join(tmp, "unpacked")
    if cli.main(["unpack", "--source-path", las["cuda"], "--target-path",
                 out]) != 0:
        raise AssertionError("unpack failed")
    log(f"pack --device (zstd, 1 worker): {walls['cuda']:.3f} s, "
        f"--device cpu {walls['cpu']:.3f} s; .la byte-identical "
        f"({os.path.getsize(las['cuda'])} bytes); launches {counts}; "
        f"unpack: {same_tree(src, out)} files byte-identical")
    require_launches("pack", counts, ("scan", "walk", "blake3", "hufpack"))
    return counts, las["cuda"], out


def stale_phase(src: str, la: str, out: str, tmp: str,
                wrappers: dict) -> dict:
    """Phase 11: change one file of the unpacked tree and bring it back
    three times, each time scanning the target on the card: a downsync of
    the archive through api.downsync(device="cuda"), the CLI's ``unpack
    --device cuda`` of the archive, and the CLI's ``downsync --device``
    (bare) of phase 4's BLAKE2 store of the same tree."""
    import torch

    from longtail_tpu_torch import api, cli
    from longtail_tpu_torch.stores.archiveblockstore import (
        ArchiveBlockStoreReader,
    )
    from longtail_tpu_torch.stores.compressblockstore import (
        CompressBlockStore,
    )
    from longtail_tpu_torch.stores.storage import FSStorage

    files = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs]
    victim = max(files, key=os.path.getsize)
    fs = FSStorage()
    reader = ArchiveBlockStoreReader(fs, la)
    runs = {  # name: (call, kernels the target scan must launch)
        "api.downsync(device=\"cuda\")": (
            lambda: api.downsync(CompressBlockStore(reader), fs, out,
                                 reader.archive.version_index,
                                 device="cuda"),
            ("scan", "walk", "blake3")),
        "cli unpack --device cuda": (
            lambda: cli.main(["unpack", "--source-path", la,
                              "--target-path", out, "--device", "cuda"]),
            ("scan", "walk", "blake3")),
        "cli downsync --device": (
            lambda: cli.main(["downsync", "--storage-uri",
                              os.path.join(tmp, "store_blake2"),
                              "--source-path",
                              os.path.join(tmp, "blake2.lvi"),
                              "--target-path", out, "--device"]),
            ("scan", "walk", "blake2")),
    }
    out_counts = {}
    for name, (call, need) in runs.items():
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            f.write(b"stale")
        reset(wrappers)
        t0 = time.perf_counter()
        rc = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc not in (None, 0):
            raise AssertionError(f"stale target, {name}: exited {rc}")
        counts = {k: w.LAUNCHES for k, w in wrappers.items()}
        log(f"stale target, {name} ({os.path.relpath(victim, out)} "
            f"changed): {wall:.3f} s; launches {counts}; "
            f"{same_tree(src, out)} files byte-identical")
        require_launches(f"stale target, {name}", counts, need)
        out_counts[name] = counts
    return out_counts


def decode_phase(tmp: str) -> None:
    """Phase 12: device LZ4 decode of full 8 MiB blocks of phase 4's LZ4
    store against host decode: the host parse, the device resolve by
    CUDA events, and each whole call by the host clock."""
    import torch

    from longtail_tpu_torch.ops import lz4
    from longtail_tpu_torch.parallel import device_decode

    blocks = [(payload, raw) for _, _, raw, payload in stored_blocks(
        os.path.join(tmp, "store_lz4")) if raw >= (8 << 20) - (1 << 16)][:4]
    if len(blocks) < 3:
        raise AssertionError(f"decode: {len(blocks)} full blocks, 3 needed")
    device_decode.decode_block_device(*blocks[0], device="cuda")   # warm-up
    t = {"device": 0.0, "host": 0.0, "parse": 0.0, "resolve": 0.0}
    rounds = []
    n_raw = 0
    for payload, raw in blocks:
        t0 = time.perf_counter()
        got = device_decode.decode_block_device(payload, raw, device="cuda")
        t["device"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = lz4.decompress(payload, raw)
        t["host"] += time.perf_counter() - t0
        if got != want:
            raise AssertionError("device LZ4 decode differs from host decode")
        t0 = time.perf_counter()
        seq = device_decode.parse_sequences(payload, raw)
        t["parse"] += time.perf_counter() - t0
        args = [torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
                .cuda()] + [torch.from_numpy(a).cuda() for a in seq]
        fn = device_decode.make_resolve_fn(raw, len(seq[0]))
        ms = cuda_ms(lambda: rounds.append(fn(*args)[1]), 1, warmup=False)
        t["resolve"] += ms / 1e3
        n_raw += raw
    k = len(blocks)
    log(f"device decode: {k} blocks of {n_raw // k} bytes byte-equal to host"
        f" decode; per block: device {t['device'] / k * 1e3:.3f} ms "
        f"({n_raw / t['device'] / 1e9:.3f} GB/s; host parse "
        f"{t['parse'] / k * 1e3:.3f} ms, resolve {t['resolve'] / k * 1e3:.3f}"
        f" ms by events, {rounds} rounds), host decode "
        f"{t['host'] / k * 1e3:.3f} ms ({n_raw / t['host'] / 1e9:.3f} GB/s)")


def bench_phase(src: str, wrappers: dict) -> dict:
    """Phase 13: bench_torch.py's nine modes in-process on the card at
    small sizes (the data plane and the mesh over 0.5 GiB, device_compress
    one 64 MiB batch, device_decode and device_entropy at bench.py's
    least sizes, compress and downsync 0.25 GiB, real over the tree
    at src), each with every launch count set to 0 before it and read
    after it.  Each mode must return exactly bench.py's keys for it plus
    device, verified where bench.py verifies, a value above 0, and a
    launch of each kernel of its path (downsync's CLI child launches in
    its own process: its upsync runs here); pack and BLAKE2 never.
    Prints each mode's JSON line.  Returns the counts by mode."""
    import bench_torch as bt

    from longtail_tpu_torch.ops import zstd, zstd_device

    gib, tcs = 1 << 30, 32768
    base = {"metric", "value", "unit", "vs_baseline"}
    zstd_ctx = {"zstd_device_ratio", "zstd_level3_ratio"} \
        if zstd_device._zstd_api() is not None else set()
    l3 = {"zstd_level3_ratio"} if zstd._load_native() is not None else set()
    data = ("scan", "walk", "blake3")
    modes = {  # mode: (call, bench.py's keys beyond base, kernels)
        "chunk_hash_compress": (
            lambda: bt.bench_data_plane(gib // 2, tcs, True, "cuda"),
            {"compress_ratio", "chunk_hash_gbps", "verified"} | zstd_ctx,
            data + ("hufpack",)),
        "chunk_hash": (
            lambda: bt.bench_data_plane(gib // 2, tcs, False, "cuda"),
            {"verified"}, data),
        "mesh_chunk_hash": (
            lambda: bt.bench_mesh_chunk_hash(gib // 2, tcs, "cuda"),
            {"n_devices"}, data),
        "device_compress": (
            lambda: bt.bench_device_compress(64 << 20, "cuda"),
            {"compress_ratio", "host_greedy_ratio",
             "assembly_gbps_per_core"}, ()),
        "device_decode": (
            lambda: bt.bench_device_decode(0, "cuda"),
            {"host_decode_gbps_per_core", "note"}, ()),
        "device_entropy": (
            lambda: bt.bench_device_entropy(0, "cuda"),
            {"section_ratio", "device_zstd_ratio"} | l3,
            ("hufpack", "hufpack_rows")),
        "compress": (lambda: bt.bench_compress(gib // 4, "cuda"), set(), ()),
        "real": (
            lambda: bt.bench_real_data(0, src, "cuda"),
            {"compress_ratio", "chunk_dedup_ratio", "raw_gb", "path"},
            data + ("hufpack",)),
        "downsync": (
            lambda: bt.bench_downsync(gib // 4, "cuda"),
            {"peak_rss_gib", "upsync_gbps", "compress_ratio"},
            data + ("hufpack",)),
    }
    if set(modes) != set(bt.MODES):
        raise AssertionError("phase 13 misses a mode of bench_torch.py")
    info = bt.device_info("cuda")
    out = {}
    for mode, (call, keys, need) in modes.items():
        reset(wrappers)
        t0 = time.perf_counter()
        result = call()
        wall = time.perf_counter() - t0
        counts = {k: w.LAUNCHES for k, w in wrappers.items()}
        result["device"] = info
        print(json.dumps(result), flush=True)
        log(f"bench {mode}: {wall:.1f} s; launches {counts}")
        if set(result) != base | keys | {"device"}:
            raise AssertionError(f"bench {mode}: keys {sorted(result)}")
        if result.get("verified", True) is not True:
            raise AssertionError(f"bench {mode}: not verified")
        if not result["value"] > 0:
            raise AssertionError(f"bench {mode}: value {result['value']}")
        require_launches(f"bench {mode}", counts, need)
        if counts["pack"] or counts["blake2"]:
            raise AssertionError(f"bench {mode} launched pack or BLAKE2")
        out[mode] = counts
    return out


def graft_phase(seed: int, smi: str, wrappers: dict) -> dict:
    """Phase 14: __graft_entry_torch__.py on the card.  entry()'s step
    equals its CPU run exactly and one call launches scan, walk, pack and
    BLAKE3 once each and nothing else; the same step at the main path's
    geometry (one 64 MiB batch of 2 x 32 MiB parts, one ragged, 32 KiB
    target) equals its plain run on the CPU, both timed; and
    dryrun_multichip over every card passes, each leg launching scan,
    walk and BLAKE3.  Returns the launches of one entry() call."""
    import torch

    import __graft_entry_torch__ as graft
    from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig

    fn, args = graft.entry()
    fn(*args)
    torch.cuda.synchronize()
    reset(wrappers)
    got = fn(*args)
    torch.cuda.synchronize()
    counts = {k: w.LAUNCHES for k, w in wrappers.items()}
    cpu_fn, cpu_args = graft.entry(device="cpu")
    err = max_abs_err([g.cpu() for g in got], cpu_fn(*cpu_args))
    log(f"graft entry(): 8 x 16 KiB, lane 0 {int(got[1][0])} chunks in "
        f"{got[2].numel()} slots; max_abs_err against entry(device=\"cpu\")"
        f" {err}; launches of one call {counts}")
    if err:
        raise AssertionError("entry() on the card differs from its CPU run")
    once = {"scan", "walk", "pack", "blake3"}
    if any(counts[k] != (1 if k in once else 0) for k in counts):
        raise AssertionError("one entry() call must launch scan, walk, "
                             "pack and BLAKE3 once each and nothing else")

    P = 32768 * 1024
    flat = structured(np.random.default_rng(seed), 2 * P)
    lengths = np.array([P, P - 12345 * 7], np.int32)
    flat[P + lengths[1]:] = 0
    cfg = ChunkerConfig.from_target(32768)
    batch = torch.from_numpy(flat).to("cuda")
    lens = torch.from_numpy(lengths).to("cuda")
    step = graft._build_step(cfg, 2, P, torch.device("cuda"))
    plain = graft._build_step(cfg, 2, P, torch.device("cpu"))
    got = step(batch, lens)
    t0 = time.perf_counter()
    want = plain(torch.from_numpy(flat), torch.from_numpy(lengths))
    plain_s = time.perf_counter() - t0
    err = max_abs_err([g.cpu() for g in got], want)
    ms = cuda_ms(lambda: step(batch, lens), 20)
    kernels_ms = device_ms(lambda: step(batch, lens), 20, (
        "scan_kernel", "walk_kernel", "pack_kernel", "blake3_kernel"))
    log(f"graft step, 2 x 32 MiB (one ragged), 32 KiB target: lane 0 "
        f"{int(got[1][0])} chunks, {got[2].numel()} slots of "
        f"{got[0].shape[1]}; max_abs_err against its plain run on the CPU "
        f"{err}; {ms:.4f} ms a call by CUDA events on the card, of which "
        f"its four kernels {kernels_ms:.4f} ms of device time; plain "
        f"{plain_s:.3f} s on the host clock ({smi})")
    if err:
        raise AssertionError("the step differs from its plain run")

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    report = graft.dryrun_multichip(n)
    log(f"graft dryrun_multichip({n}): every leg passed in "
        f"{time.perf_counter() - t0:.1f} s; launches: sharded (NCCL, {n} "
        f"rank(s)) {report['sharded']}, mesh {report['mesh']}, two "
        f"processes {report['multihost']}")
    for leg in ("sharded", "mesh", "multihost"):
        require_launches(f"dryrun_multichip {leg}", report[leg],
                         ("scan", "walk", "blake3"))
    return counts


class WriteBudget:
    """Delegating storage whose write paths raise ENOSPC after ``budget``
    successful writes (tests/test_torch_faults.py's FailingStorage)."""

    def __init__(self, inner, budget: int):
        import threading

        self._inner = inner
        self._budget = budget
        self._lock = threading.Lock()

    def _spend(self):
        import errno

        from longtail_tpu_torch.stores.storage import StorageError

        with self._lock:
            if self._budget <= 0:
                raise StorageError(errno.ENOSPC, "No space left on device",
                                   "injected")
            self._budget -= 1

    def write(self, path, data, offset=0):
        self._spend()
        return self._inner.write(path, data, offset)

    def write_ranges(self, path, size, ranges):
        self._spend()
        return self._inner.write_ranges(path, size, ranges)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class BadSource:
    """Delegating storage over a source whose file ``name`` fails from
    byte ``at`` on: "fail" raises EIO from a read that starts there,
    "short" halves the bytes past it (a file truncated after its listing;
    tests/test_torch_faults.py's ShortReads).  ``map_file`` maps through
    a whole-file read, or refuses with ``no_map`` so the file is read
    part by part."""

    def __init__(self, inner, name: str, at: int, mode: str,
                 no_map: bool):
        self._inner = inner
        self._name = name
        self._at = at
        self._mode = mode
        self._no_map = no_map

    def read(self, path, offset=0, size=None):
        import errno

        from longtail_tpu_torch.stores.storage import StorageError

        hit = path.endswith(self._name)
        if hit and self._mode == "fail" and offset >= self._at:
            raise StorageError(errno.EIO, "injected read error", path)
        data = self._inner.read(path, offset, size)
        keep = max(0, self._at - offset)
        if hit and self._mode == "short" and len(data) > keep:
            data = data[:keep + (len(data) - keep) // 2]
        return data

    def map_file(self, path):
        import errno

        from longtail_tpu_torch.stores.storage import MappedFile, StorageError

        if self._no_map:
            raise StorageError(errno.ENOTSUP, "no map", path)
        return MappedFile(memoryview(self.read(path)))

    def __getattr__(self, name):
        return getattr(self._inner, name)


def limited(name: str, fn, wrappers: dict, limit: float = 120.0) -> tuple:
    """Run fn() on a thread joined with a timeout of ``limit`` s, raising
    if it has not ended by then.  Returns ({"value": ...} or {"error":
    exception}, wall s, launches), the launch counts set to 0 before."""
    import threading

    import torch

    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            out["error"] = e

    reset(wrappers)
    t0 = time.perf_counter()
    t = threading.Thread(target=run, name=f"fault {name}", daemon=True)
    t.start()
    t.join(limit)
    if t.is_alive():
        raise AssertionError(f"fault scenario {name}: no end within "
                             f"{limit:.0f} s")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: w.LAUNCHES for k, w in wrappers.items()}


def expect(name: str, out: dict, types, err_no=None, text=None):
    """The exception of a scenario: one of ``types``, with ``err_no`` and
    ``text`` in its message where given; else raise."""
    e = out.get("error")
    if not isinstance(e, types) or (err_no is not None
                                     and e.errno != err_no) or \
            (text is not None and text not in str(e)):
        raise AssertionError(f"fault scenario {name}: expected "
                             f"{types} {err_no or ''} {text or ''}, got "
                             f"{e!r}") from e
    return e


def succeeded(name: str, out: dict):
    if "error" in out:
        raise AssertionError(f"fault scenario {name} raised") \
            from out["error"]
    return out["value"]


def stale(root: str) -> None:
    """Change every file of a tree in its middle."""
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            n = os.path.getsize(p)
            if n:
                with open(p, "r+b") as fh:
                    fh.seek(n // 2)
                    fh.write(b"stale"[: n - n // 2])


def fault_phase(tmp: str, src: str, src_small: str, seed: int,
                wrappers: dict) -> None:
    """Phase 15: the fault paths on the card, each scenario on a thread
    joined with a 120 s limit and held to the exception its CPU case in
    tests/test_torch_faults.py asserts: (a) ENOSPC from the store while
    the card codecs write blocks, LZ4 and zstd (the Huffman pack); (b) a
    StorageError from the read of the 3rd part of a 160 MiB file, an
    earlier batch on the card (the reader thread); (c) a source file
    shorter than its listing, read and mapped; (d) a corrupt, then a
    truncated store.lsi, under which a card upsync finds every block by a
    scan of the .lrb files and a downsync reproduces the tree;
    (e) a cancel during a downsync whose stale target was re-indexed on
    the card; (f) a missing block file under such a downsync; (g) two
    card upsyncs into one store at once, through the .lsi lock.  Then
    Python's thread count must be back to its value before the phase
    within 5 s, and phase 4's zstd upsync, run again, must write phase
    4's .lvi.  Logs each scenario's wall and launches."""
    import errno
    import threading

    from longtail_tpu_torch import api, cli
    from longtail_tpu_torch.core.indexing import (
        create_version_index,
        get_files_recursively,
    )
    from longtail_tpu_torch.formats import constants as C
    from longtail_tpu_torch.formats.store_index import StoreIndex
    from longtail_tpu_torch.stores.compressblockstore import (
        CompressBlockStore,
    )
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage, StorageError
    from longtail_tpu_torch.utils.cancel import Cancelled, CancelToken

    threads_before = threading.active_count()
    fs = FSStorage()
    lz4, zstd = C.COMPRESSION_TYPE_LZ4_DEFAULT, C.COMPRESSION_TYPE_ZSTD_DEFAULT
    data = ("scan", "walk", "blake3")
    base = os.path.join(tmp, "faults")
    os.makedirs(base)

    def card_store(path, storage=fs):
        return CompressBlockStore(FSBlockStore(storage, path), device="cuda")

    def record(name, wall, counts, what, need=()):
        log(f"fault {name}: {what}; {wall:.3f} s; launches {counts}")
        require_launches(f"fault {name}", counts, need)
        if counts["pack"]:
            raise AssertionError(f"fault scenario {name} launched pack")

    # (a) ENOSPC while the card codecs write blocks
    for codec, tag in (("lz4", lz4), ("zstd", zstd)):
        name = f"(a) ENOSPC, {codec}"
        out, wall, counts = limited(name, lambda: api.upsync(
            fs, src_small, card_store(os.path.join(base, f"a_{codec}"),
                                      WriteBudget(fs, 1)),
            compression_tag=tag, device="cuda"), wrappers)
        e = expect(name, out, StorageError, errno.ENOSPC)
        record(name, wall, counts, f"{type(e).__name__} errno {e.errno}",
               data + (("hufpack",) if codec == "zstd" else ()))

    # (b) a read error on the 3rd part of a 160 MiB file
    big = os.path.join(base, "b_src")
    os.makedirs(big)
    structured(np.random.default_rng(seed + 15), 160 << 20).tofile(
        os.path.join(big, "big.bin"))
    part = C.DEFAULT_TARGET_CHUNK_SIZE * 1024
    name = "(b) read error, 3rd part"
    out, wall, counts = limited(name, lambda: api.upsync(
        BadSource(fs, "big.bin", 2 * part, "fail", no_map=True), big,
        FSBlockStore(fs, os.path.join(base, "b_store")), device="cuda"),
        wrappers)
    e = expect(name, out, StorageError, errno.EIO)
    record(name, wall, counts, f"{type(e).__name__} errno {e.errno} "
           f"({e.filename})", ("scan", "walk"))

    # (c) a source file shorter than its listing
    short = os.path.join(base, "c_src")
    os.makedirs(short)
    rng = np.random.default_rng(seed + 16)
    rng.integers(0, 256, 9 << 20, dtype=np.uint8).tofile(
        os.path.join(short, "big.bin"))
    rng.integers(0, 256, 5000, dtype=np.uint8).tofile(
        os.path.join(short, "small.bin"))
    for branch in ("map", "read"):
        name = f"(c) short read, {branch}"
        out, wall, counts = limited(name, lambda: api.upsync(
            BadSource(fs, "big.bin", 3 << 20, "short",
                      no_map=branch == "read"), short,
            FSBlockStore(fs, os.path.join(base, f"c_{branch}")),
            device="cuda"), wrappers)
        e = expect(name, out, StorageError, errno.EIO, "short read")
        record(name, wall, counts, f"{type(e).__name__}: {e}")

    # (d) a damaged store.lsi: a card upsync finds the blocks by a scan
    store_d = os.path.join(base, "d_store")
    vi0, _ = api.upsync(fs, src_small, card_store(store_d),
                        compression_tag=lz4, device="cuda")
    blocks = lrb_set(store_d)
    lsi = os.path.join(store_d, "store.lsi")
    blob = open(lsi, "rb").read()
    for damage in ("corrupt", "truncated"):
        with open(lsi, "wb") as f:
            f.write(b"\xde\xad\xbe\xef" * 64 if damage == "corrupt"
                    else blob[: len(blob) // 2])
        name = f"(d) {damage} store.lsi"
        out, wall, counts = limited(name, lambda: api.upsync(
            fs, src_small, card_store(store_d), compression_tag=lz4,
            device="cuda"), wrappers)
        vi, vsi = succeeded(name, out)
        covered = set(int(h) for h in vsi.chunk_hashes)
        if vi.to_bytes() != vi0.to_bytes() or lrb_set(store_d) != blocks \
                or any(int(h) not in covered for h in vi.chunk_hashes):
            raise AssertionError(f"fault scenario {name}: the scan did not "
                                 "find every block")
        out_dir = os.path.join(base, f"d_{damage}")
        api.downsync(CompressBlockStore(FSBlockStore(fs, store_d)), fs,
                     out_dir, vi)
        record(name, wall, counts, f"found by a scan: .lvi as before, "
               f"{len(blocks)} blocks, none written again; a downsync "
               f"through it: {same_tree(src_small, out_dir)} files "
               "byte-identical", data)
    with open(lsi, "wb") as f:
        f.write(blob)

    # (e) a cancel during a downsync whose stale target the card re-indexed
    target = os.path.join(base, "e_target")
    api.downsync(CompressBlockStore(FSBlockStore(fs, store_d)), fs, target,
                 vi0)
    stale(target)
    token = CancelToken()

    def cancelling(done, total):
        token.cancel()

    name = "(e) cancel, stale target"
    out, wall, counts = limited(name, lambda: api.downsync(
        CompressBlockStore(FSBlockStore(fs, store_d)), fs, target, vi0,
        workers=1, cancel_token=token, progress=cancelling,
        device="cuda"), wrappers)
    e = expect(name, out, Cancelled)
    record(name, wall, counts, type(e).__name__, data)
    api.downsync(CompressBlockStore(FSBlockStore(fs, store_d)), fs, target,
                 vi0, device="cuda")
    log(f"fault {name}: a downsync after it restores the tree, "
        f"{same_tree(src_small, target)} files byte-identical")

    # (f) a missing block file under a downsync over a stale target
    store_f = os.path.join(base, "f_store")
    shutil.copytree(store_d, store_f)
    victim = sorted(os.path.join(d, f) for d, _, fs_ in os.walk(store_f)
                    for f in fs_ if f.endswith(".lrb"))[0]
    os.remove(victim)
    stale(target)
    name = "(f) missing block file"
    out, wall, counts = limited(name, lambda: api.downsync(
        CompressBlockStore(FSBlockStore(fs, store_f)), fs, target, vi0,
        device="cuda"), wrappers)
    e = expect(name, out, (StorageError, FileNotFoundError, KeyError))
    record(name, wall, counts, f"{type(e).__name__} errno "
           f"{getattr(e, 'errno', None)} ({os.path.basename(victim)} "
           "removed)", data)

    # (g) two card upsyncs into one store at once
    other = os.path.join(base, "g_src")
    make_tree(other, 32 << 20, seed + 17)
    store_g = os.path.join(base, "g_store")

    def both():
        vis, errs = {}, []

        def one(root):
            try:
                vis[root] = api.upsync(fs, root, card_store(store_g),
                                       compression_tag=lz4,
                                       device="cuda")[0]
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        ts = [threading.Thread(target=one, args=(r,))
              for r in (src_small, other)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]
        return vis

    name = "(g) two upsyncs, one store"
    out, wall, counts = limited(name, both, wrappers)
    vis = succeeded(name, out)
    infos = get_files_recursively(fs, other)
    host = create_version_index(
        fs, other, infos, C.HASH_TYPE_BLAKE3, C.DEFAULT_TARGET_CHUNK_SIZE,
        asset_tags=np.full(infos.count, lz4, np.uint32), device=None)
    if vis[src_small].to_bytes() != vi0.to_bytes() or \
            vis[other].to_bytes() != host.to_bytes():
        raise AssertionError(f"fault scenario {name}: an .lvi differs from "
                             "its host path's")
    on_disk = set(int(h) for h in StoreIndex.from_bytes(open(
        os.path.join(store_g, "store.lsi"), "rb").read()).chunk_hashes)
    cold = CompressBlockStore(FSBlockStore(fs, store_g))
    for k, (root, vi) in enumerate(vis.items()):
        if any(int(h) not in on_disk for h in vi.chunk_hashes):
            raise AssertionError(f"fault scenario {name}: chunks lost in "
                                 "the .lsi merge")
        out_dir = os.path.join(base, f"g_out{k}")
        api.downsync(cold, fs, out_dir, vi)
        same_tree(root, out_dir)
    record(name, wall, counts, "both .lvi equal their host path's, the "
           "merged store.lsi holds both, both trees come back from a cold "
           "store", data)

    deadline = time.monotonic() + 5
    while threading.active_count() > threads_before and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    left = threading.active_count()
    log(f"faults: Python threads {left} after the scenarios, "
        f"{threads_before} before")
    if left > threads_before:
        raise AssertionError("threads left behind by the fault scenarios: "
                             f"{[t.name for t in threading.enumerate()]}")

    t0 = time.perf_counter()
    rc = cli.main(["upsync", "--storage-uri",
                   os.path.join(base, "store_zstd_again"), "--source-path",
                   src, "--target-path", os.path.join(base, "again.lvi")])
    wall = time.perf_counter() - t0
    again = open(os.path.join(base, "again.lvi"), "rb").read()
    if rc != 0 or again != open(os.path.join(tmp, "zstd.lvi"), "rb").read():
        raise AssertionError("after the faults, phase 4's zstd upsync "
                             "wrote another .lvi")
    log(f"faults: phase 4's zstd upsync again: {wall:.3f} s, .lvi "
        "byte-identical to phase 4's")
    shutil.rmtree(base)


class RssPeak:
    """The peak resident set of this process while a ``with`` block runs,
    sampled from /proc/self/statm every 20 ms on a thread."""

    def __enter__(self):
        import threading

        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            with open("/proc/self/statm") as f:
                self.peak = max(self.peak, int(f.read().split()[1]) * page)
            if self._stop.wait(0.02):
                return

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    @property
    def gib(self) -> float:
        return self.peak / (1 << 30)


def large_asset_phase(work: str, smi: str, wrappers: dict) -> None:
    """Phase 16: one asset of 4 GiB + 4097 bytes (tests/
    test_reference_depth.py's offset-mixed 1 MiB tile, hashed with sha256
    as it is written) at the library defaults: indexed on the host path,
    upsynced on the card with LZ4 (CompressBlockStore(device="cuda")),
    whose .lvi must equal the host path's with an asset size past 2^32;
    the source deleted, then downsynced into a fresh folder, whose sha256
    must equal the source's.  Works under ``work`` and needs 9 GiB free
    there (the source and the store, then the store and the target);
    raises without it.  Logs each step's wall, GB/s and peak RSS and the
    upsync's launches."""
    import torch

    from longtail_tpu_torch import api
    from longtail_tpu_torch.core.indexing import (
        create_version_index,
        get_files_recursively,
    )
    from longtail_tpu_torch.formats import constants as C
    from longtail_tpu_torch.formats.version_index import VersionIndex
    from longtail_tpu_torch.stores.compressblockstore import (
        CompressBlockStore,
    )
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage

    size = (4 << 30) + 4097
    os.makedirs(work, exist_ok=True)
    free = shutil.disk_usage(work).free
    if free < 9 << 30:
        raise AssertionError(f"phase 16 needs 9 GiB free under {work}; "
                             f"{free / (1 << 30):.2f} GiB are")
    root = tempfile.mkdtemp(prefix="lt_large_", dir=work)
    try:
        src = os.path.join(root, "src")
        os.makedirs(src)
        path = os.path.join(src, "huge.bin")
        lz4 = C.COMPRESSION_TYPE_LZ4_DEFAULT
        fs = FSStorage()

        def step(name, t0, rss):
            wall = time.perf_counter() - t0
            log(f"large asset, {name}: {wall:.3f} s, "
                f"{size / wall / 1e9:.3f} GB/s; peak RSS {rss.gib:.3f} GiB")

        t0 = time.perf_counter()
        with RssPeak() as rss:
            tile = np.arange(1 << 18, dtype=np.uint32)
            want = hashlib.sha256()
            with open(path, "wb") as f:
                off = 0
                while off < size:
                    chunk = ((tile + np.uint32(off >> 20))
                             ^ np.uint32(0xA5)).tobytes()[
                                 : min(1 << 20, size - off)]
                    f.write(chunk)
                    want.update(chunk)
                    off += len(chunk)
        step("source written and hashed (sha256)", t0, rss)

        t0 = time.perf_counter()
        with RssPeak() as rss:
            infos = get_files_recursively(fs, src)
            host = create_version_index(
                fs, src, infos, C.HASH_TYPE_BLAKE3,
                C.DEFAULT_TARGET_CHUNK_SIZE,
                asset_tags=np.full(infos.count, lz4, np.uint32), workers=8,
                device=None)
        step("host index (device=None)", t0, rss)

        store = os.path.join(root, "store")
        reset(wrappers)
        t0 = time.perf_counter()
        with RssPeak() as rss:
            vi, _ = api.upsync(fs, src, CompressBlockStore(
                FSBlockStore(fs, store), device="cuda"),
                compression_tag=lz4, device="cuda")
            torch.cuda.synchronize()
        counts = {k: w.LAUNCHES for k, w in wrappers.items()}
        step(f"upsync on the card, LZ4 ({vi.chunk_count} chunks; launches "
             f"{counts})", t0, rss)
        require_launches("large asset upsync", counts,
                         ("scan", "walk", "blake3"))
        if counts["pack"]:
            raise AssertionError("the large asset's upsync launched pack")
        if int(vi.asset_sizes.max()) != size or size <= 1 << 32:
            raise AssertionError("large asset: the asset is not past 2^32 "
                                 "bytes")
        if vi.to_bytes() != host.to_bytes():
            raise AssertionError("large asset: the card's .lvi differs "
                                 "from the host path's")
        log(f"large asset: .lvi byte-identical to the host path's, asset "
            f"{size} bytes > 2^32 ({smi})")

        os.remove(path)
        out = os.path.join(root, "out")
        t0 = time.perf_counter()
        with RssPeak() as rss:
            api.downsync(CompressBlockStore(FSBlockStore(fs, store)), fs,
                         out, VersionIndex.from_bytes(vi.to_bytes()))
        step("downsync into a fresh folder", t0, rss)
        t0 = time.perf_counter()
        got = hashlib.sha256()
        with open(os.path.join(out, "huge.bin"), "rb") as f:
            while b := f.read(1 << 22):
                got.update(b)
        if got.hexdigest() != want.hexdigest():
            raise AssertionError("large asset: the downsync's sha256 "
                                 "differs from the source's")
        log(f"large asset: downsync sha256 equal to the source's "
            f"({got.hexdigest()[:16]}, {time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gib", type=float, default=1.0,
                    help="size of the synthetic asset tree in GiB")
    ap.add_argument("--blake2-gib", type=float, default=1 / 32,
                    help="size of the tree of the BLAKE2 upsync in GiB")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels phase")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from longtail_tpu_torch import _kernels, api, cli
    from longtail_tpu_torch.core.indexing import (
        create_version_index,
        get_files_recursively,
    )
    from longtail_tpu_torch.formats import constants as C
    from longtail_tpu_torch.formats.version_index import VersionIndex
    from longtail_tpu_torch.ops import (
        blake2_kernel,
        blake3_kernel,
        compression_registry,
        entropy_kernel,
        lz4,
        pack,
        zstd,
    )
    from longtail_tpu_torch.parallel import pipeline, stage1
    from longtail_tpu_torch.stores.compressblockstore import (
        CompressBlockStore,
    )
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)                                  # card name, power limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _kernels.load()
    log(f"build: {time.perf_counter() - t0:.2f} s ({_kernels.LIB_PATH})")

    # 3. kernels against their plain versions
    rows = check_kernels(args.seed)
    if args.kernels_only:
        print(json.dumps({"kernels": rows}))
        return 0

    # 4. main path: the CLI's upsync on the card, zstd (default), LZ4,
    # BLAKE2; the card is the default, and --device takes it bare or named
    wrappers = {"scan": stage1.scan, "walk": stage1.walk,
                "pack": pack.pack,
                "blake3": blake3_kernel.hash_chunks_device,
                "blake2": blake2_kernel.hash_chunks_device,
                "hufpack": entropy_kernel.hufpack_frame,
                "hufpack_rows": entropy_kernel.hufpack}
    paths = {  # name: (extra flags, kernels the path must launch, tree)
        "zstd": ([], ("scan", "walk", "blake3", "hufpack"), "src"),
        "lz4": (["--device", "--compression-algorithm", "lz4"],
                ("scan", "walk", "blake3"), "src"),
        "blake2": (["--device", "cuda", "--hash-algorithm", "blake2"],
                   ("scan", "walk", "blake2", "hufpack"), "src_b2"),
    }
    # batches of the pipeline, to hold a hash to one launch per batch
    plan_hash = pipeline.DevicePartIndexer.plan_hash

    def counted_plan_hash(self, *a, **k):
        counted_plan_hash.BATCHES += 1
        return plan_hash(self, *a, **k)

    pipeline.DevicePartIndexer.plan_hash = counted_plan_hash
    tmp = tempfile.mkdtemp(prefix="lt_chip_smoke_")
    try:
        trees = {}
        for tree, gib in (("src", args.gib), ("src_b2", args.blake2_gib)):
            path = os.path.join(tmp, tree)
            trees[tree] = (path, make_tree(path, int(gib * (1 << 30)),
                                           args.seed))
            log(f"tree: {trees[tree][1]} bytes under {path}")
        src = trees["src"][0]
        fs = FSStorage()
        launches = {}
        walls = {}
        for name, (extra, need, tree) in paths.items():
            tree_dir, total = trees[tree]
            reset(wrappers)
            stage1.repair_lane.REPAIRS = 0
            counted_plan_hash.BATCHES = 0
            t0 = time.perf_counter()
            rc = cli.main(["upsync", "--storage-uri",
                           os.path.join(tmp, f"store_{name}"),
                           "--source-path", tree_dir, "--target-path",
                           os.path.join(tmp, f"{name}.lvi"), *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: w.LAUNCHES for k, w in wrappers.items()}
            batches = counted_plan_hash.BATCHES
            summary = store_summary(os.path.join(tmp, f"store_{name}"),
                                    "lz4" if name == "lz4" else "zstd")
            log(f"upsync {' '.join(extra) or '(zstd, blake3, the card)'}: "
                f"rc {rc}, {wall:.3f} s, {total / wall / 1e9:.3f} GB/s, "
                f"ratio {summary['raw'] / summary['stored']:.4f}; "
                f"launches {counts}; {batches} batches; ambiguous lanes "
                f"repaired {stage1.repair_lane.REPAIRS}; blocks {summary}")
            if rc != 0:
                raise AssertionError(f"upsync {name} exited {rc}")
            walls[name] = wall
            require_launches(name, counts, need)
            for k in need:
                launches.setdefault(k, counts[k])
            hash_kind = "blake2" if "blake2" in need else "blake3"
            if counts[hash_kind] != batches:
                raise AssertionError(f"the {name} path launched {hash_kind} "
                                     f"{counts[hash_kind]} times in "
                                     f"{batches} batches")
            if counts["pack"]:
                raise AssertionError(f"the {name} path launched pack: "
                                     "the hashes read the batch")
            # a zstd frame per device-route block, one pack launch a frame
            if "hufpack" in need and \
                    counts["hufpack"] > summary["device_route"]:
                raise AssertionError(
                    f"the {name} path launched hufpack {counts['hufpack']} "
                    f"times for {summary['device_route']} frames")

        # 5. held to the host
        for name, hash_id, tag in (
                ("zstd", C.HASH_TYPE_BLAKE3, C.COMPRESSION_TYPE_ZSTD_DEFAULT),
                ("lz4", C.HASH_TYPE_BLAKE3, C.COMPRESSION_TYPE_LZ4_DEFAULT),
                ("blake2", C.HASH_TYPE_BLAKE2,
                 C.COMPRESSION_TYPE_ZSTD_DEFAULT)):
            lvi = open(os.path.join(tmp, f"{name}.lvi"), "rb").read()
            tree_dir = trees[paths[name][2]][0]
            infos = get_files_recursively(fs, tree_dir)
            t0 = time.perf_counter()
            host = create_version_index(
                fs, tree_dir, infos, hash_id, C.DEFAULT_TARGET_CHUNK_SIZE,
                asset_tags=np.full(infos.count, tag, np.uint32), workers=8,
                device=None)
            t_host = time.perf_counter() - t0
            if lvi != host.to_bytes():
                raise AssertionError(f"{name}: .lvi differs from the host "
                                     "path's")
            out = os.path.join(tmp, "out")
            store = CompressBlockStore(FSBlockStore(
                fs, os.path.join(tmp, f"store_{name}")))
            api.downsync(store, fs, out, VersionIndex.from_bytes(lvi))
            log(f"{name}: .lvi byte-identical to the host path's "
                f"({len(lvi)} bytes; host index {t_host:.3f} s); downsync: "
                f"{same_tree(tree_dir, out)} files byte-identical")
            shutil.rmtree(out)

        for name, host_compress in (
                ("zstd", lambda b: zstd.compress(b, 3)),
                ("lz4", lz4.compress)):
            store = CompressBlockStore(FSBlockStore(
                fs, os.path.join(tmp, f"store_{name}")))
            raw_total = dev_total = host_total = 0
            sampled = 0
            for h, tag, raw, payload in stored_blocks(
                    os.path.join(tmp, f"store_{name}")):
                data = store.get_stored_block(h).block_data
                raw_total += raw
                dev_total += len(payload)
                host_total += len(host_compress(data))
                if raw >= (8 << 20) - (1 << 16) and sampled < 3:
                    cpu = compression_registry.get_codec(tag, "cpu")
                    if cpu.compress(tag, data) != payload:
                        raise AssertionError(
                            f"{name}: block {h:#x} recompressed on the CPU "
                            "differs from the card's")
                    sampled += 1
            if sampled < 2:
                raise AssertionError(f"{name}: under 2 full blocks sampled")
            log(f"{name}: {sampled} sampled 8 MiB blocks recompressed on "
                f"the CPU equal the card's; ratio {raw_total / dev_total:.4f}"
                f" against host {name}"
                f"{' level 3' if name == 'zstd' else ''} "
                f"{raw_total / host_total:.4f} over the same blocks")

        # 6. stage 4
        stage4(src, 4, wrappers)

        # 7-12. the mesh, the distributed steps, two processes, pack,
        # a stale target, device decode
        mesh_phase(src, trees["src"][1], tmp, walls["lz4"], wrappers,
                   counted_plan_hash)
        distributed_phase(src, wrappers)
        pipeline.DevicePartIndexer.plan_hash = plan_hash
        multihost_phase(src, tmp)
        _, la, unpacked = pack_phase(trees["src_b2"][0], tmp, wrappers)
        stale_phase(trees["src_b2"][0], la, unpacked, tmp, wrappers)
        decode_phase(tmp)

        # 13. bench_torch.py's nine modes
        t0 = time.perf_counter()
        bench_phase(src, wrappers)
        log(f"bench phase: {time.perf_counter() - t0:.1f} s")

        # 14. __graft_entry_torch__.py: the step and the distributed legs;
        # the only path that launches pack
        t0 = time.perf_counter()
        launches["pack"] = graft_phase(args.seed, smi, wrappers)["pack"]
        for r in rows:
            r["launches"] = launches.get(r["name"], 0)
        log(f"graft phase: {time.perf_counter() - t0:.1f} s")

        # 15. the fault paths on the card
        t0 = time.perf_counter()
        fault_phase(tmp, src, trees["src_b2"][0], args.seed, wrappers)
        log(f"fault phase: {time.perf_counter() - t0:.1f} s")

        # 16. one asset over 4 GiB on the card
        t0 = time.perf_counter()
        large_asset_phase(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "build"), smi, wrappers)
        log(f"large asset phase: {time.perf_counter() - t0:.1f} s")
    finally:
        pipeline.DevicePartIndexer.plan_hash = plan_hash
        shutil.rmtree(tmp, ignore_errors=True)

    if any(m == "jax" or m.startswith(("jax.", "longtail_tpu."))
           or m == "longtail_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
