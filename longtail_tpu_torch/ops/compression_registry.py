"""Compression codecs keyed by block tag (the reference's CompressionAPI +
registry seam, src/longtail.h:266-294,
lib/compressionregistry/longtail_full_compression_registry.c) — the
port's copy of ``longtail_tpu/ops/compression_registry.py``.

Tag 0 stores raw.  'lz42' is the LZ4 block format
(lib/lz4/longtail_lz4.c:10).  'ztd1'..'ztd5' are the zstd quality tiers
(lib/zstd/longtail_zstd.c:17-22) backed by our RFC 8878 implementation.

Each codec carries a ``device``, which takes the place of the JAX
package's process-wide ``use_device`` switches: None compresses with the
host codecs, a torch device with the device codecs
(``parallel/device_lz4.py``, ``ops/zstd_device.py``).  The setting
belongs to the codec instance (and so to the store that asks for it),
never to the process.  Decompression, and brotli altogether, run on the
host; the stored bytes are the same standard formats either way.
"""

from __future__ import annotations

from longtail_tpu_torch.formats import constants as C
from longtail_tpu_torch.ops import lz4, zstd


class Lz4Codec:
    tags = (C.COMPRESSION_TYPE_LZ4_DEFAULT,)

    def __init__(self, device=None):
        self.device = device

    def compress(self, tag: int, data: bytes) -> bytes:
        if self.device is not None:
            from longtail_tpu_torch.parallel import device_lz4
            return device_lz4.compress_block(data, self.device)
        return lz4.compress(data)

    def decompress(self, tag: int, data: bytes, raw_size: int) -> bytes:
        return lz4.decompress(data, raw_size)

    def decompress_into(self, tag: int, data, out) -> None:
        """Zero-extra-copy decode into a caller buffer (downsync path)."""
        lz4.decompress_into(data, out)


class ZstdCodec:
    """Quality tiers mirror the reference's min/default/max/high/low
    (lib/zstd/longtail_zstd.c:17-22); level feeds the match-finder effort."""

    tags = (C.COMPRESSION_TYPE_ZSTD_MIN, C.COMPRESSION_TYPE_ZSTD_DEFAULT,
            C.COMPRESSION_TYPE_ZSTD_MAX, C.COMPRESSION_TYPE_ZSTD_HIGH,
            C.COMPRESSION_TYPE_ZSTD_LOW)
    # upstream zstd levels per the reference tier map
    # (lib/zstd/longtail_zstd.c:11-15): min=0(=default), low=2, default=3,
    # high=8, max=ZSTD_MAX_CLEVEL(22)
    levels = {C.COMPRESSION_TYPE_ZSTD_MIN: 0,
              C.COMPRESSION_TYPE_ZSTD_LOW: 2,
              C.COMPRESSION_TYPE_ZSTD_DEFAULT: 3,
              C.COMPRESSION_TYPE_ZSTD_HIGH: 8,
              C.COMPRESSION_TYPE_ZSTD_MAX: 22}

    def __init__(self, device=None):
        self.device = device

    def compress(self, tag: int, data: bytes) -> bytes:
        level = self.levels.get(tag, 3)
        if self.device is not None:
            from longtail_tpu_torch.ops import zstd_device
            return zstd_device.compress_block(data, level,
                                              device=self.device)
        return zstd.compress(data, level)

    def decompress(self, tag: int, data: bytes, raw_size: int) -> bytes:
        return zstd.decompress(data, raw_size)

    def decompress_into(self, tag: int, data, out) -> None:
        """Zero-extra-copy decode into a caller buffer (downsync path)."""
        zstd.decompress_into(data, out)


class BrotliCodec:
    """Generic/text x min/default/max tiers (lib/brotli/longtail_brotli.c:
    24-30).  ALWAYS registered: the reference always ships brotli
    (vendored 1.1), so reference-written stores may carry btl* blocks on
    any host.  Decompression always works — the system libbrotli when
    present, else the from-spec RFC 7932 decoder (ops/brotli_decode.py)
    — so reference-written brotli stores stay readable everywhere.
    Compression (an encoder) still needs libbrotli; without it a btl*
    upsync fails with a clear actionable error instead of the
    pre-round-5 silent tag-not-registered path, which returned
    compressed bytes as if raw — data corruption, not an error."""

    tags = (C.COMPRESSION_TYPE_BROTLI_GENERIC_MIN,
            C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT,
            C.COMPRESSION_TYPE_BROTLI_GENERIC_MAX,
            C.COMPRESSION_TYPE_BROTLI_TEXT_MIN,
            C.COMPRESSION_TYPE_BROTLI_TEXT_DEFAULT,
            C.COMPRESSION_TYPE_BROTLI_TEXT_MAX)
    _quality = {C.COMPRESSION_TYPE_BROTLI_GENERIC_MIN: 4,
                C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT: 8,
                C.COMPRESSION_TYPE_BROTLI_GENERIC_MAX: 11,
                C.COMPRESSION_TYPE_BROTLI_TEXT_MIN: 4,
                C.COMPRESSION_TYPE_BROTLI_TEXT_DEFAULT: 8,
                C.COMPRESSION_TYPE_BROTLI_TEXT_MAX: 11}
    _text = (C.COMPRESSION_TYPE_BROTLI_TEXT_MIN,
             C.COMPRESSION_TYPE_BROTLI_TEXT_DEFAULT,
             C.COMPRESSION_TYPE_BROTLI_TEXT_MAX)

    def __init__(self, device=None):
        self.device = device            # brotli has no device tier

    def compress(self, tag: int, data: bytes) -> bytes:
        from longtail_tpu_torch.ops import brotli
        if not brotli.available():
            raise RuntimeError(
                f"block uses brotli compression tag {tag:#010x} (btl*)"
                " but the system libbrotli (libbrotlienc) is not"
                " installed on this host — install libbrotli to write"
                " brotli-tagged stores (reading works without it)")
        return brotli.compress(data, self._quality.get(tag, 8),
                               text_mode=tag in self._text)

    def decompress(self, tag: int, data: bytes, raw_size: int) -> bytes:
        from longtail_tpu_torch.ops import brotli
        return brotli.decompress(data, raw_size)


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
