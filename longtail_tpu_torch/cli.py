"""Command-line interface mirroring the reference CLI (cmd/main.c):
upsync / downsync / validate / ls / cp / pack / unpack, with the same flag
names and defaults (:2956-3105) — the port of ``longtail_tpu/cli.py``.

Usage: python -m longtail_tpu_torch.cli <command> [flags]

``upsync`` and ``pack`` run on the CUDA card by default what the JAX
package's ``--device`` runs on its accelerator: the chunk+hash data plane
(BLAKE3 or BLAKE2; meow always chunks and hashes on the host, as in the
JAX package) and the match search of the LZ4 and zstd block codecs, with
zstd's Huffman literal pack; they raise where there is no card.
``--device`` takes an optional value: ``cuda`` (the default, bare or
absent), ``cpu`` (the kernels' plain versions on the CPU) or ``host``
(the host path, the JAX package's default).  ``downsync`` and ``unpack``
take the same ``--device``: it names where an existing target is
re-indexed (``api.downsync``; a fresh folder touches no device), and
they decode on the host.  ``validate``, ``ls`` and ``cp`` touch no device
and take no ``--device``.  A downsync defaults
``--min-block-usage-percent`` to 0, as the reference C does.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from longtail_tpu_torch import api
from longtail_tpu_torch.formats import constants as C
from longtail_tpu_torch.formats.version_index import VersionIndex
from longtail_tpu_torch.ops.compression_registry import supported_tags
from longtail_tpu_torch.stores.compressblockstore import CompressBlockStore
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
from longtail_tpu_torch.stores.storage import FSStorage, ensure_parent_dirs
from longtail_tpu_torch.utils import log
from longtail_tpu_torch.utils.progress import RateLimitedProgress

HASH_NAMES = {
    "blake2": C.HASH_TYPE_BLAKE2,
    "blake3": C.HASH_TYPE_BLAKE3,
    "meow": C.HASH_TYPE_MEOW,
}

COMPRESSION_NAMES = {
    "none": C.COMPRESSION_TYPE_NONE,
    "lz4": C.COMPRESSION_TYPE_LZ4_DEFAULT,
    "zstd": C.COMPRESSION_TYPE_ZSTD_DEFAULT,
    "zstd_min": C.COMPRESSION_TYPE_ZSTD_MIN,
    "zstd_max": C.COMPRESSION_TYPE_ZSTD_MAX,
    "zstd_high": C.COMPRESSION_TYPE_ZSTD_HIGH,
    "zstd_low": C.COMPRESSION_TYPE_ZSTD_LOW,
    "brotli": C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT,
    "brotli_min": C.COMPRESSION_TYPE_BROTLI_GENERIC_MIN,
    "brotli_max": C.COMPRESSION_TYPE_BROTLI_GENERIC_MAX,
    "brotli_text": C.COMPRESSION_TYPE_BROTLI_TEXT_DEFAULT,
    "brotli_text_min": C.COMPRESSION_TYPE_BROTLI_TEXT_MIN,
    "brotli_text_max": C.COMPRESSION_TYPE_BROTLI_TEXT_MAX,
}

# --device values: the torch device of the data plane and codecs, None
# for the host path
DEVICE_NAMES = {"cuda": "cuda", "cpu": "cpu", "host": None}


def _progress(label: str):
    start = time.monotonic()

    def show(done, total):
        pct = 100 * done // max(total, 1)
        sys.stderr.write(f"\r{label}: {pct}% ({done}/{total})")
        if done >= total:
            sys.stderr.write(f" [{time.monotonic() - start:.2f}s]\n")
        sys.stderr.flush()
    return RateLimitedProgress(show)


def _open_store(storage_uri: str, compression_needed: bool = True):
    fs = FSStorage()
    store = FSBlockStore(fs, storage_uri)
    return CompressBlockStore(store) if compression_needed else store


def _device(args):
    """The torch device that --device names (the card when absent), None
    for the host path."""
    name = DEVICE_NAMES[args.device or "cuda"]
    return None if name is None else torch.device(name)


def cmd_upsync(args) -> int:
    device = _device(args)
    storage = FSStorage()
    store = CompressBlockStore(FSBlockStore(storage, args.storage_uri),
                               device=device)
    vi, vsi = api.upsync(
        storage, args.source_path.rstrip("/"), store,
        target_chunk_size=args.target_chunk_size,
        target_block_size=args.target_block_size,
        max_chunks_per_block=args.max_chunks_per_block,
        min_block_usage_percent=args.min_block_usage_percent,
        hash_identifier=HASH_NAMES[args.hash_algorithm],
        compression_tag=COMPRESSION_NAMES[args.compression_algorithm],
        workers=args.workers, device=device,
        progress=_progress("upsync"))
    ensure_parent_dirs(storage, args.target_path)
    storage.write(args.target_path, vi.to_bytes())
    if args.version_local_store_index_path:
        ensure_parent_dirs(storage, args.version_local_store_index_path)
        storage.write(args.version_local_store_index_path, vsi.to_bytes())
    print(f"upsync: {vi.asset_count} assets, {vi.chunk_count} chunks "
          f"-> {args.target_path}")
    return 0


def cmd_downsync(args) -> int:
    storage = FSStorage()
    # reference downsync chain: fs [-> cache] -> compress (cmd/main.c:1264).
    # Fetch read-ahead lives in change_version's channel-1 job-graph
    # fetch jobs (the reference's channel-1 block readers), so no prefetch
    # wrapper is needed here.
    backing = FSBlockStore(FSStorage(), args.storage_uri)
    if args.cache_path:
        from longtail_tpu_torch.stores.cacheblockstore import CacheBlockStore
        local = FSBlockStore(FSStorage(), args.cache_path)
        backing = CacheBlockStore(local, backing)
    store = CompressBlockStore(backing)
    vi = VersionIndex.from_bytes(storage.read(args.source_path))
    current = None
    if args.target_index_path:
        current = VersionIndex.from_bytes(storage.read(args.target_index_path))
    api.downsync(store, storage, args.target_path.rstrip("/"), vi,
                 current_version_index=current,
                 retain_permissions=not args.no_retain_permissions,
                 min_block_usage_percent=args.min_block_usage_percent,
                 workers=args.workers, device=_device(args),
                 progress=_progress("downsync"))
    print(f"downsync: materialized {vi.asset_count} assets at "
          f"{args.target_path}")
    return 0


def cmd_validate(args) -> int:
    storage = FSStorage()
    store = _open_store(args.storage_uri, compression_needed=False)
    vi = VersionIndex.from_bytes(storage.read(args.version_index_path))
    result = api.validate_version(store, vi)
    if result.ok:
        print(f"validate: OK ({vi.asset_count} assets, "
              f"{vi.chunk_count} chunks)")
        return 0
    print(f"validate: FAILED — {len(result.missing_chunk_hashes)} missing "
          f"chunks, {len(result.size_mismatch_chunk_hashes)} size mismatches")
    return 1


def cmd_ls(args) -> int:
    storage = FSStorage()
    vi = VersionIndex.from_bytes(storage.read(args.version_index_path))
    prefix = (args.path or "").strip("/")
    from longtail_tpu_torch.stores.blockstorestorage import list_version_dir
    for name, size, is_dir, perm in list_version_dir(vi, prefix):
        kind = "d" if is_dir else "-"
        print(f"{kind}{perm:>5o} {size:>12} {name}")
    return 0


def cmd_cp(args) -> int:
    storage = FSStorage()
    store = _open_store(args.storage_uri)
    vi = VersionIndex.from_bytes(storage.read(args.version_index_path))
    from longtail_tpu_torch.stores.blockstorestorage import BlockStoreStorage
    bss = BlockStoreStorage(store, vi)
    data = bss.read(args.source_path.strip("/"))
    ensure_parent_dirs(storage, args.target_path)
    storage.write(args.target_path, data)
    print(f"cp: {args.source_path} -> {args.target_path} ({len(data)} bytes)")
    return 0


def cmd_pack(args) -> int:
    from longtail_tpu_torch.stores.archiveblockstore import pack_archive
    storage = FSStorage()
    n_assets, n_blocks, size = pack_archive(
        storage, args.source_path.rstrip("/"), args.target_path,
        target_chunk_size=args.target_chunk_size,
        target_block_size=args.target_block_size,
        max_chunks_per_block=args.max_chunks_per_block,
        hash_identifier=HASH_NAMES[args.hash_algorithm],
        compression_tag=COMPRESSION_NAMES[args.compression_algorithm],
        workers=args.workers, device=_device(args),
        progress=_progress("pack"))
    print(f"pack: {n_assets} assets in {n_blocks} blocks -> "
          f"{args.target_path} ({size} bytes)")
    return 0


def cmd_unpack(args) -> int:
    from longtail_tpu_torch.stores.archiveblockstore import unpack_archive
    storage = FSStorage()
    n_assets = unpack_archive(
        storage, args.source_path, args.target_path.rstrip("/"),
        retain_permissions=not args.no_retain_permissions,
        workers=args.workers, device=_device(args),
        progress=_progress("unpack"))
    print(f"unpack: materialized {n_assets} assets at {args.target_path}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="longtail-tpu-torch",
        description="incremental asset delivery on PyTorch and CUDA")
    p.add_argument("--log-level", default="warn")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--detailed-progress", action="store_true",
                   help="live block/asset activity line (the terminal "
                        "analog of the reference's MiniFB grid)")
    p.add_argument("--mem-tracer", action="store_true",
                   help="trace memory usage per phase and print a summary "
                        "(reference --mem-tracer, cmd/main.c:2959)")
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(sp, what):
        sp.add_argument("--device", nargs="?", const="cuda", default=None,
                        choices=sorted(DEVICE_NAMES),
                        help=f"where {what}: cuda (the default, bare "
                             "or absent), cpu (the kernels' plain versions) "
                             "or host (the host path)")

    def common_chunking(sp):
        sp.add_argument("--target-chunk-size", type=int, default=32768)
        sp.add_argument("--target-block-size", type=int, default=8388608)
        sp.add_argument("--max-chunks-per-block", type=int, default=1024)
        sp.add_argument("--hash-algorithm", default="blake3",
                        choices=sorted(HASH_NAMES))
        # reference default: zstd (cmd/main.c:2988)
        sp.add_argument("--compression-algorithm", default="zstd",
                        choices=sorted(COMPRESSION_NAMES))
        device_flag(sp, "the chunk+hash data plane and the block codecs run")

    sp = sub.add_parser("upsync", help="index a folder and upload new blocks")
    sp.add_argument("--storage-uri", required=True)
    sp.add_argument("--source-path", required=True)
    sp.add_argument("--target-path", required=True,
                    help="output .lvi version index file")
    sp.add_argument("--version-local-store-index-path")
    sp.add_argument("--min-block-usage-percent", type=int, default=0)
    common_chunking(sp)
    sp.set_defaults(fn=cmd_upsync)

    sp = sub.add_parser("downsync", help="materialize a version locally")
    sp.add_argument("--storage-uri", required=True)
    sp.add_argument("--source-path", required=True, help=".lvi file")
    sp.add_argument("--target-path", required=True, help="target folder")
    sp.add_argument("--target-index-path")
    sp.add_argument("--cache-path")
    sp.add_argument("--min-block-usage-percent", type=int, default=0)
    sp.add_argument("--no-retain-permissions", action="store_true")
    device_flag(sp, "an existing target folder is re-indexed")
    sp.set_defaults(fn=cmd_downsync)

    sp = sub.add_parser("validate", help="check a store covers a version")
    sp.add_argument("--storage-uri", required=True)
    sp.add_argument("--version-index-path", required=True)
    sp.set_defaults(fn=cmd_validate)

    sp = sub.add_parser("ls", help="list a version index")
    sp.add_argument("--version-index-path", required=True)
    # accepted for reference CLI-flag parity (cmd/main.c:3238): ls reads
    # names/sizes from the .lvi alone, but the reference's ls takes the
    # store URI too, so scripts written against it keep working
    sp.add_argument("--storage-uri", default=None,
                    help="accepted for reference parity; ls only needs "
                         "the version index")
    sp.add_argument("path", nargs="?", default="")
    sp.set_defaults(fn=cmd_ls)

    sp = sub.add_parser("cp", help="copy a file out of a store")
    sp.add_argument("--storage-uri", required=True)
    sp.add_argument("--version-index-path", required=True)
    sp.add_argument("source_path")
    sp.add_argument("target_path")
    sp.set_defaults(fn=cmd_cp)

    sp = sub.add_parser("pack", help="pack a folder into one archive file")
    sp.add_argument("--source-path", required=True)
    sp.add_argument("--target-path", required=True, help="output .la file")
    common_chunking(sp)
    sp.set_defaults(fn=cmd_pack)

    sp = sub.add_parser("unpack", help="unpack an archive file to a folder")
    sp.add_argument("--source-path", required=True, help=".la file")
    sp.add_argument("--target-path", required=True, help="target folder")
    sp.add_argument("--no-retain-permissions", action="store_true")
    device_flag(sp, "an existing target folder is re-indexed")
    sp.set_defaults(fn=cmd_unpack)

    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    try:
        log.set_level(args.log_level)
    except ValueError as e:
        p.error(str(e))
    # fail fast on codec tags whose backing is missing on this host
    # (brotli tags are always registered so stored btl* blocks error
    # clearly on read, but an upsync about to spend chunking work should
    # reject up front)
    tag = COMPRESSION_NAMES.get(getattr(args, "compression_algorithm", ""))
    if tag not in (None, C.COMPRESSION_TYPE_NONE):
        if tag not in supported_tags():
            p.error(f"--compression-algorithm {args.compression_algorithm} "
                    "is not available (no codec registered on this host)")
        if getattr(args, "compression_algorithm", "").startswith("brotli"):
            from longtail_tpu_torch.ops import brotli as _b
            if not _b.available():
                p.error(f"--compression-algorithm "
                        f"{args.compression_algorithm} needs the system "
                        "libbrotli (libbrotlienc/libbrotlidec), which is "
                        "not installed on this host")
    if args.detailed_progress:
        from longtail_tpu_torch.utils.detailed_progress import \
            TerminalDetailedProgress
        from longtail_tpu_torch.utils.monitor import set_monitor
        set_monitor(TerminalDetailedProgress())
    if args.mem_tracer:
        from longtail_tpu_torch.utils import memtracer
        memtracer.install()
    try:
        with log.log_context(command=args.command):
            return args.fn(args)
    finally:
        if args.mem_tracer:
            from longtail_tpu_torch.utils import memtracer
            print(memtracer.dump_stats(), file=sys.stderr)
            memtracer.uninstall()


if __name__ == "__main__":
    sys.exit(main())
