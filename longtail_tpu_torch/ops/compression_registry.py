"""Block codecs keyed by block tag, with the match search of LZ4 and zstd
on a torch device — port of ``longtail_tpu/ops/compression_registry.py``.

Each codec carries a ``device``, which takes the place of the JAX
package's process-wide ``use_device`` switches: None compresses with the
host codecs, a torch device with the device codecs
(``parallel/device_lz4.py``, ``ops/zstd_device.py``).  The setting
belongs to the codec instance (and so to the store that asks for it),
never to the process, and the JAX package's registry and its class
attributes are never touched.  Decompression, and brotli altogether,
delegate to the host package's codecs; the stored bytes are the same
standard formats either way.
"""

from __future__ import annotations

from longtail_tpu_torch import _host

C = _host.constants


class Lz4Codec:
    tags = (C.COMPRESSION_TYPE_LZ4_DEFAULT,)

    def __init__(self, device=None):
        self.device = device

    def compress(self, tag: int, data: bytes) -> bytes:
        if self.device is not None:
            from longtail_tpu_torch.parallel import device_lz4
            return device_lz4.compress_block(data, self.device)
        return _host.lz4.compress(data)

    def decompress(self, tag: int, data: bytes, raw_size: int) -> bytes:
        return _host.lz4.decompress(data, raw_size)

    def decompress_into(self, tag: int, data, out) -> None:
        _host.lz4.decompress_into(data, out)


class ZstdCodec:
    """The reference's quality tiers (lib/zstd/longtail_zstd.c:11-22)."""

    tags = _host.HostZstdCodec.tags
    levels = _host.HostZstdCodec._levels

    def __init__(self, device=None):
        self.device = device

    def compress(self, tag: int, data: bytes) -> bytes:
        level = self.levels.get(tag, 3)
        if self.device is not None:
            from longtail_tpu_torch.ops import zstd_device
            return zstd_device.compress_block(data, level,
                                              device=self.device)
        return _host.zstd.compress(data, level)

    def decompress(self, tag: int, data: bytes, raw_size: int) -> bytes:
        return _host.zstd.decompress(data, raw_size)

    def decompress_into(self, tag: int, data, out) -> None:
        _host.zstd.decompress_into(data, out)


class BrotliCodec(_host.HostBrotliCodec):
    """The host package's brotli codec: brotli has no device tier."""

    def __init__(self, device=None):
        self.device = device


_CODECS = {tag: cls for cls in (Lz4Codec, ZstdCodec, BrotliCodec)
           for tag in cls.tags}


def get_codec(tag: int, device=None):
    """The codec for ``tag``, compressing on ``device`` (None: host)."""
    try:
        return _CODECS[tag](device)
    except KeyError:
        raise KeyError(f"no compression codec registered for tag {tag:#x}")


def supported_tags() -> set[int]:
    return set(_CODECS)
