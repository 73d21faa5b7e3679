"""Command-line interface of the port: the reference CLI's commands and
flags (``longtail_tpu/cli.py``), with ``upsync --device`` running on the
CUDA card what the JAX package's ``--device`` runs on its accelerator:
the chunk+hash data plane (BLAKE3 or BLAKE2) and the match search of the
LZ4 and zstd block codecs, with zstd's Huffman literal pack.

Usage: python -m longtail_tpu_torch.cli <command> [flags]

``upsync`` writes through the port's ``CompressBlockStore``, whose codecs
run on the card with ``--device`` and on the host without it.
``--device`` is ported only for ``upsync`` with ``--hash-algorithm
blake3`` or ``blake2``; anywhere else it raises instead of quietly
running the host path.  The other commands run the host package's
implementation.
"""

from __future__ import annotations

import sys

import torch

from longtail_tpu_torch import _host, api
from longtail_tpu_torch.core.indexing import DEVICE_HASH_KINDS
from longtail_tpu_torch.ops.compression_registry import supported_tags
from longtail_tpu_torch.stores.compressblockstore import CompressBlockStore

_hc = _host.host_cli


def cmd_upsync(args) -> int:
    device = None
    if args.device:
        hash_identifier = _hc.HASH_NAMES[args.hash_algorithm]
        if hash_identifier not in DEVICE_HASH_KINDS:
            raise NotImplementedError(
                f"upsync --device with --hash-algorithm "
                f"{args.hash_algorithm} is not ported yet (only "
                f"{' and '.join(sorted(DEVICE_HASH_KINDS.values()))} are)")
        device = torch.device("cuda")
    storage = _host.FSStorage()
    store = CompressBlockStore(_host.FSBlockStore(storage, args.storage_uri),
                               device=device)
    vi, vsi = api.upsync(
        storage, args.source_path.rstrip("/"), store,
        target_chunk_size=args.target_chunk_size,
        target_block_size=args.target_block_size,
        max_chunks_per_block=args.max_chunks_per_block,
        min_block_usage_percent=args.min_block_usage_percent,
        hash_identifier=_hc.HASH_NAMES[args.hash_algorithm],
        compression_tag=_hc.COMPRESSION_NAMES[args.compression_algorithm],
        workers=args.workers, device=device,
        progress=_hc._progress("upsync"))
    _hc.ensure_parent_dirs(storage, args.target_path)
    storage.write(args.target_path, vi.to_bytes())
    if args.version_local_store_index_path:
        _hc.ensure_parent_dirs(storage, args.version_local_store_index_path)
        storage.write(args.version_local_store_index_path, vsi.to_bytes())
    print(f"upsync: {vi.asset_count} assets, {vi.chunk_count} chunks "
          f"-> {args.target_path}")
    return 0


def main(argv=None) -> int:
    p = _hc.build_parser()
    args = p.parse_args(argv)
    if args.command == "upsync":
        args.fn = cmd_upsync
    elif getattr(args, "device", False):
        raise NotImplementedError(
            f"{args.command} --device is not ported yet (only upsync is)")
    try:
        _host.log.set_level(args.log_level)
    except ValueError as e:
        p.error(str(e))
    # fail fast on a codec whose backing is missing on this host
    name = getattr(args, "compression_algorithm", "")
    tag = _hc.COMPRESSION_NAMES.get(name)
    if tag not in (None, _host.constants.COMPRESSION_TYPE_NONE):
        if tag not in supported_tags():
            p.error(f"--compression-algorithm {name} is not available "
                    "(no codec registered on this host)")
        if name.startswith("brotli") and not _host.brotli.available():
            p.error(f"--compression-algorithm {name} needs the system "
                    "libbrotli, which is not installed on this host")
    if args.detailed_progress:
        _host.set_monitor(_host.TerminalDetailedProgress())
    if args.mem_tracer:
        _host.memtracer.install()
    try:
        with _host.log.log_context(command=args.command):
            return args.fn(args)
    finally:
        if args.mem_tracer:
            print(_host.memtracer.dump_stats(), file=sys.stderr)
            _host.memtracer.uninstall()


if __name__ == "__main__":
    sys.exit(main())
