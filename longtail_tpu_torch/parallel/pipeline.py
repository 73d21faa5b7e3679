"""Batched device chunk+hash pipeline — port of
``longtail_tpu/parallel/pipeline.py``.

File parts are batched ``lanes`` at a time into one uint8 tensor and
stream through three stages:

- **Stage 1 (device)**: the scan and walk kernels (``parallel/stage1.py``)
  resolve every part's chunk boundaries; only the walk output
  ``(lanes, c_pad + 2)`` int32 comes back to the host.
- **Stage 2 (host plan)**: a lane flagged ambiguous is re-chunked
  exactly on the host, and stage 3 is planned: the BLAKE3 kernel's work
  plan, or the BLAKE2 kernel's chunk order.
- **Stage 3 (device)**: BLAKE3 (``ops/blake3_kernel.py``) or BLAKE2
  (``ops/blake2_kernel.py``) hashes every chunk of the batch in one
  launch, reading its bytes from the resident batch.  The digests come
  back in one copy, in chunk order.
- **Stage 4 (device, optional)**: ``submit_compress`` finds LZ match
  anchors per block of the resident batch (``parallel/device_match.py``)
  from the scan's bin-mins (``compress=True``) or from the batch's words,
  and ``collect_compress`` brings them back in one copy.

Host data reaches the card through pinned buffers with non-blocking
copies on the current stream, and each stage's result comes back the same
way, so the host waits only where the JAX package does its two fetches
per batch (``plan_hash`` and ``retire``): stage 1 of later batches and
stage 3 of earlier ones stay queued on the card while the host plans.

A batch moves between the stages as a ``Walked`` entry (after stage 1)
and a ``Hashed`` entry (after stage 3).  ``index_stream`` is the one
pipelined loop: ``DevicePartIndexer`` runs it over itself, and
``MeshPartIndexer`` deals batches round-robin over one
``DevicePartIndexer`` per device.  With ``device="cpu"`` every wrapper
computes its plain version, which is how the tests hold the port against
the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
from collections import deque
from typing import Iterable, Iterator, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from longtail_tpu_torch.ops import blake2, blake2_kernel, blake3, blake3_kernel
from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig
from longtail_tpu_torch.parallel.device_match import (
    bins_anchors_packed,
    decode_packed,
    fast_anchors_packed,
)
from longtail_tpu_torch.parallel.stage1 import (
    Stage1Plan,
    hash_table,
    repair_lane,
    stage1,
    unpack_walk,
)
from longtail_tpu_torch.utils.device import resolve_device
from longtail_tpu_torch.utils.monitor import carry, span

HASH_KINDS = ("blake3", "blake2")


class Walked(NamedTuple):
    """A batch after stage 1 (``submit``): its lanes' bytes and the walk
    output on its way to the host."""
    tags: list
    dev_rows: torch.Tensor          # (lanes * part_bytes,) uint8 resident
    lengths: np.ndarray             # (lanes,) int32
    walk_host: torch.Tensor         # walk output, fetched to the host
    event: object                   # its copy's CUDA event, None on the CPU
    host_rows: np.ndarray | None    # the same bytes on the host
    bins: torch.Tensor | None       # the scan's bin-mins (compress=True)


class Hashed(NamedTuple):
    """A batch after stage 3 (``plan_hash``): its chunk sizes and the
    digests on their way to the host; ``words`` and ``bins`` are set only
    with keep_words=True, for stage 4."""
    tags: list
    lane_sizes: list                # per lane, u32 chunk sizes
    counts: np.ndarray              # per lane, its chunk count
    digests_host: torch.Tensor      # (2, n) digests, fetched to the host
    event: object
    words: torch.Tensor | None      # the resident batch as int32 words
    bins: torch.Tensor | None


def _prefetch(it: Iterable, depth: int) -> Iterator:
    """Pull from `it` on a background thread so file I/O overlaps device
    compute (depth 0: on the caller's thread).  Closing the generator
    (its consumer gave up) stops the thread at its next put and joins it,
    so no reader is left blocked on a full queue holding its parts."""
    if not depth:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for x in it:
                if not put(x):
                    return
            put(_END)
        except BaseException as e:  # propagate into the consumer
            put(e)

    t = threading.Thread(target=carry(worker), daemon=True)
    t.start()
    try:
        while True:
            with span("index.read_wait"):
                x = q.get()
            if x is _END:
                return
            if isinstance(x, BaseException):
                raise x
            yield x
    finally:
        stop.set()
        t.join()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class DevicePartIndexer:
    """Streams file parts through the device chunk+hash pipeline.

    ``target_chunk_size`` fixes the chunking geometry and the part size
    (``target_chunk_size * 1024``); ``batch_bytes`` sizes the lane batch.
    ``device`` is where the data plane runs: a CUDA device runs the
    kernels, ``"cpu"`` their plain versions.  ``hash_kind`` ("blake3" or
    "blake2") picks the chunk hash; ``compress=True`` has the scan also
    emit the anchor bin-mins that stage 4 (``submit_compress``) reads.
    """

    def __init__(self, target_chunk_size: int, device,
                 batch_bytes: int = 64 << 20, lanes: int | None = None,
                 hash_kind: str = "blake3", compress: bool = False):
        device = resolve_device(device)
        part_bytes = target_chunk_size * 1024
        if lanes is None:
            lanes = max(1, batch_bytes // part_bytes)
            if device.type == "cpu":
                # the plain versions gain nothing from wide batches, and
                # their int64 intermediates are 8x the batch
                lanes = min(lanes, 8)
        self._setup(ChunkerConfig.from_target(target_chunk_size),
                    part_bytes, lanes, device, hash_kind, compress)

    @classmethod
    def for_geometry(cls, cfg: ChunkerConfig, part_bytes: int, lanes: int,
                     device, hash_kind: str = "blake3"):
        """An indexer of an explicit chunking geometry and lane width
        (part_bytes a multiple of stage1.SCAN_TILE): the single-step
        ``device_chunker.index_parts``."""
        self = cls.__new__(cls)
        self._setup(cfg, part_bytes, lanes, resolve_device(device),
                    hash_kind, False)
        return self

    def _setup(self, cfg: ChunkerConfig, part_bytes: int, lanes: int,
               device: torch.device, hash_kind: str, compress: bool):
        if hash_kind not in HASH_KINDS:
            raise ValueError(f"no device hasher for {hash_kind!r}")
        self.hash_kind = hash_kind
        self.compress = compress
        self.device = device
        self.cfg = cfg
        self.part_bytes = part_bytes
        self.lanes = lanes
        self.plan = Stage1Plan(self.cfg, self.lanes, self.part_bytes)
        # in-flight batches per stage: deep enough that each stage's one
        # host wait overlaps other batches' device work
        self.queue_depth = 3
        self._table = hash_table(self.device)
        self._pinned = self.device.type == "cuda"

    # -- host <-> device staging --------------------------------------------

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self._pinned)

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """Async copy of a host tensor (pinned when on CUDA) to the device."""
        return t.to(self.device, non_blocking=True) if self._pinned else t

    def _fetch(self, t: torch.Tensor):
        """Start the async copy of t to a pinned host buffer; returns
        (host tensor, event to wait on, or None on the CPU)."""
        if not self._pinned:
            return t, None
        host = self._host_buffer(t.shape, t.dtype)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    # -- stage 1 ----------------------------------------------------------

    def submit(self, tags, dev_rows: torch.Tensor, lengths: np.ndarray,
               host_rows: np.ndarray | None = None):
        """Stage 1 on a device-resident (lanes * part_bytes,) uint8 batch:
        queue scan + walk and the async fetch of the walk output.
        host_rows (the same bytes on the host) makes lane repair cheap.
        With compress=True the scan's bin-mins ride in the entry."""
        lens = self._host_buffer((self.lanes,), torch.int32)
        lens.numpy()[:] = lengths
        lens = self._upload(lens)
        out, bins = stage1(dev_rows, lens, self._table, self.plan,
                           with_bins=self.compress)
        out_host, ev = self._fetch(out)
        return Walked(tags, dev_rows, lengths, out_host, ev, host_rows, bins)

    def submit_host(self, batch):
        """Stage 1 from host parts: copy (tag, bytes) pairs into a pinned
        batch buffer, upload it, queue stage 1."""
        B, P = self.lanes, self.part_bytes
        tags = [t for t, _ in batch]
        # the copy reads mapped files: their page faults land here
        with span("index.stage") as s:
            buf = self._host_buffer((B * P,), torch.uint8)
            flat = buf.numpy()
            lengths = np.zeros((B,), dtype=np.int32)
            for i, (_, part) in enumerate(batch):
                part = np.asarray(part, dtype=np.uint8)
                if len(part) > P:
                    raise ValueError(
                        f"part of {len(part)} bytes > part_bytes {P}")
                flat[i * P: i * P + len(part)] = part
                flat[i * P + len(part): (i + 1) * P] = 0
                lengths[i] = len(part)
            flat[len(batch) * P:] = 0
            dev = self._upload(buf)
            s.n = int(lengths.sum())
        return self.submit(tags, dev, lengths, host_rows=flat)

    # -- stage 2 + 3 ------------------------------------------------------

    def plan_hash(self, entry: Walked, keep_words: bool = False) -> Hashed:
        """Stage 2: wait for the walk output, repair flagged lanes, plan
        the hash; stage 3: queue the hash (one launch) and the async fetch
        of all digests.

        keep_words=True keeps the resident batch viewed as int32 words
        and the scan's bin-mins (or None) in the returned entry, so that
        stage 4 runs on the same device-resident data."""
        tags, dev_rows, lengths, out_host, ev, host_rows, bins = entry
        P = self.part_bytes
        n_lanes = len(tags)
        with span("index.card_wait"):
            if ev is not None:
                ev.synchronize()
        with span("index.plan") as s:
            sizes, counts, amb = unpack_walk(out_host.numpy(), self.plan)
            for b in range(n_lanes):
                if amb[b]:
                    if host_rows is not None:
                        lane = host_rows[b * P: b * P + lengths[b]]
                    else:
                        lane = dev_rows[b * P: b * P + lengths[b]] \
                            .cpu().numpy()
                    fixed = repair_lane(lane, self.cfg)
                    counts[b] = len(fixed)
                    sizes[b, : len(fixed)] = fixed
                    sizes[b, len(fixed):] = 0

            lane_sizes = []
            all_starts, all_sizes = [], []
            for b in range(n_lanes):
                sz = sizes[b, : counts[b]].astype(np.int64)
                lane_sizes.append(sz.astype(np.uint32))
                st = np.zeros(len(sz), dtype=np.int64)
                np.cumsum(sz[:-1], out=st[1:])
                all_starts.append(st + b * P)
                all_sizes.append(sz)
            flat_starts = np.concatenate(all_starts) if all_starts \
                else np.zeros(0, np.int64)
            flat_sizes = np.concatenate(all_sizes) if all_sizes \
                else np.zeros(0, np.int64)
            res_host, ev = self._fetch(self._hash(dev_rows, flat_starts,
                                                  flat_sizes))
            out = Hashed(tags, lane_sizes, counts[:n_lanes], res_host, ev,
                         dev_rows.view(torch.int32) if keep_words else None,
                         bins if keep_words else None)
            s.n = len(flat_sizes)
        return out

    def _hash(self, dev_rows, starts: np.ndarray, sizes: np.ndarray):
        """Every chunk in one launch of the hash kernel, read from the
        resident batch; one upload of starts, sizes and the kernel's work
        plan (BLAKE3: plan_blocks; BLAKE2: its chunk order, plan_order).
        Returns the (2, n) digests in chunk order."""
        n = len(sizes)
        if self.hash_kind == "blake3":
            plan = blake3.plan_blocks(blake3.leaves_of(sizes))
            kernel = blake3_kernel.hash_chunks_device
        else:
            plan = blake2.plan_order(sizes)
            kernel = blake2_kernel.hash_chunks_device
        blob = self._host_buffer((2 * n + len(plan),), torch.int32)
        bnp = blob.numpy()
        bnp[:n], bnp[n:2 * n], bnp[2 * n:] = starts, sizes, plan
        blob = self._upload(blob)
        lo, hi = kernel(dev_rows, blob[:n], blob[n:2 * n], blob[2 * n:])
        return torch.stack([lo, hi])

    # -- stage 4 ----------------------------------------------------------

    def submit_compress(self, entry: Hashed, block_bytes: int = 8 << 20,
                        max_offset_words: int = 16383):
        """Stage 4: queue the fast-tier anchor extraction for the batch of
        an entry from plan_hash(keep_words=True), per ``block_bytes``
        block, and the async fetch of its single packed result.  With
        compress=True only the bin-level sorts run (the scan already read
        the bytes); otherwise the bin-mins come from the resident words
        first.  Collect with collect_compress()."""
        if entry.bins is not None:
            packed = bins_anchors_packed(entry.bins, block_bytes // 256,
                                         max_offset_words=max_offset_words)
        else:
            packed = fast_anchors_packed(entry.words, block_bytes // 4,
                                         max_offset_words=max_offset_words)
        return self._fetch(packed)

    @staticmethod
    def collect_compress(handle):
        """Wait for stage 4's result: per-block position-sorted byte-offset
        (pos, ref) anchor lists, ready for the host LZ4 assembler
        (``assemble_anchors``) or the zstd sequence walk."""
        packed, ev = handle
        if ev is not None:
            ev.synchronize()
        return decode_packed(packed.numpy())

    def retire(self, entry: Hashed):
        """Stage 3 drain: wait for the digests and yield
        (tag, sizes u32, hashes u64) per part in submission order."""
        with span("index.card_wait"):
            if entry.event is not None:
                entry.event.synchronize()
        res = entry.digests_host.numpy().view(np.uint32).astype(np.uint64)
        hashes = res[0] | (res[1] << np.uint64(32))
        off = 0
        for tag, sz, cnt in zip(entry.tags, entry.lane_sizes, entry.counts):
            yield tag, sz, hashes[off: off + int(cnt)]
            off += int(cnt)

    def index_stream(self, tagged_parts: Iterable[Tuple[object, np.ndarray]],
                     prefetch_depth: int | None = None,
                     ) -> Iterator[Tuple[object, np.ndarray, np.ndarray]]:
        """Consume (tag, part_bytes) pairs; yield (tag, sizes u32, hashes u64)
        per part in submission order. Parts must be <= part_bytes long."""
        return index_stream([self], tagged_parts, prefetch_depth)


class MeshPartIndexer:
    """The data plane over several devices: one DevicePartIndexer per
    device, batches dealt round-robin, results retired in global
    submission order (``longtail_tpu/parallel/pipeline.py:844``).

    ``devices`` are torch devices or their names; one may appear more than
    once, which puts two indexers on one card.  Every indexer runs the
    same kernels as the single-device path.  An entry carries the events
    of its own copies, recorded on its device's current stream, so an
    indexer waits only for its own batches (and, on a shared card, for
    the work queued before them on that stream).  Global dedup stays with
    the caller: a host unique in ``create_version_index``, or the
    all-gather of ``parallel/distributed.py`` across processes."""

    def __init__(self, target_chunk_size: int, devices,
                 batch_bytes_per_dev: int = 64 << 20,
                 lanes: int | None = None, hash_kind: str = "blake3"):
        devices = list(devices)
        if not devices:
            raise ValueError("MeshPartIndexer needs at least one device")
        self.indexers = [
            DevicePartIndexer(target_chunk_size, d,
                              batch_bytes=batch_bytes_per_dev, lanes=lanes,
                              hash_kind=hash_kind)
            for d in devices
        ]
        self.part_bytes = self.indexers[0].part_bytes
        self.cfg = self.indexers[0].cfg

    def index_stream(self, tagged_parts: Iterable[Tuple[object, np.ndarray]],
                     prefetch_depth: int | None = None,
                     ) -> Iterator[Tuple[object, np.ndarray, np.ndarray]]:
        """DevicePartIndexer.index_stream's contract, fanned out over
        every indexer."""
        return index_stream(self.indexers, tagged_parts, prefetch_depth)


# ---------------------------------------------------------------------------
# the streaming loop
# ---------------------------------------------------------------------------

def index_stream(indexers: Sequence[DevicePartIndexer],
                 tagged_parts: Iterable[Tuple[object, np.ndarray]],
                 prefetch_depth: int | None = None,
                 ) -> Iterator[Tuple[object, np.ndarray, np.ndarray]]:
    """Consume (tag, part_bytes) pairs; yield (tag, sizes u32, hashes u64)
    per part in submission order.  Batches of the first indexer's lane
    count are dealt round-robin over ``indexers``; each stage holds
    ``queue_depth`` batches per indexer, and parts are read
    2 * lanes * len(indexers) ahead (``prefetch_depth`` overrides)."""
    n = len(indexers)
    B = indexers[0].lanes
    depth = prefetch_depth if prefetch_depth is not None else 2 * B * n
    d = indexers[0].queue_depth * n
    deal = itertools.cycle(indexers)
    stage1q: deque = deque()   # (indexer, entry), FIFO = global order
    stage2q: deque = deque()
    batch: list = []

    def submit(batch):
        ix = next(deal)
        stage1q.append((ix, ix.submit_host(batch)))

    def plan():
        ix, e = stage1q.popleft()
        stage2q.append((ix, ix.plan_hash(e)))

    def retire():
        ix, e = stage2q.popleft()
        return ix.retire(e)

    with contextlib.closing(_prefetch(tagged_parts, depth)) as src:
        for item in src:
            batch.append(item)
            if len(batch) == B:
                submit(batch)
                batch = []
                if len(stage1q) >= d:
                    plan()
                if len(stage2q) >= d:
                    yield from retire()
    if batch:
        submit(batch)
    while stage1q:
        plan()
    while stage2q:
        yield from retire()
