"""Compression wrapper store whose codecs run their match search on a
torch device: the host package's ``CompressBlockStore``
(``longtail_tpu/stores/compressblockstore.py``,
lib/compressblockstore/longtail_compressblockstore.c) with compression
through the port's codec registry.

Put: when the block tag names a codec, the chunk payload becomes
``[u32 raw_size][u32 compressed_size][compressed payload]`` (:118-139);
tag 0 passes through raw (:86-93).  ``device`` is where the codecs run
their match search: None for the host codecs, or a torch device.  Get,
and everything else, is the host store's: the stored bytes are standard
formats, which the host codecs decode.
"""

from __future__ import annotations

from longtail_tpu_torch import _host
from longtail_tpu_torch.ops.compression_registry import get_codec
from longtail_tpu_torch.parallel.pipeline import resolve_device


def compress_block(stored_block, device=None):
    tag = stored_block.block_index.tag
    if tag == 0:
        return stored_block
    raw = stored_block.block_data
    comp = get_codec(tag, device).compress(tag, raw)
    return _host.StoredBlock(
        block_index=stored_block.block_index,
        block_data=_host.COMPRESSED_BLOCK_HEADER.pack(len(raw), len(comp))
        + comp)


class CompressBlockStore(_host.HostCompressBlockStore):
    def __init__(self, backing, device=None):
        super().__init__(backing)
        self.device = None if device is None else resolve_device(device)

    def put_stored_block(self, stored_block) -> None:
        self.stats.bump("put_stored_block_count")
        self.backing.put_stored_block(compress_block(stored_block,
                                                     self.device))
