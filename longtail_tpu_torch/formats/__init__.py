"""Zero-parse binary formats bit-compatible with the reference longtail library.

All formats are little-endian structure-of-arrays blobs that the reference
reads by walking pointers into a single buffer (``src/longtail.c``:
``InitVersionIndexFromData`` :2613, ``InitStoreIndexFromData`` :8979,
``Longtail_InitBlockIndexFromData`` :3652).  We mirror the byte layout exactly
so ``.lvi`` / ``.lsi`` / ``.lrb`` / ``.la`` files interoperate, but represent
them in memory as numpy arrays (the natural host-side mirror of device
buffers).
"""

from longtail_tpu_torch.formats.constants import (
    VERSION_INDEX_VERSION_0_0_2,
    STORE_INDEX_VERSION_1_0_0,
    ARCHIVE_VERSION_0_0_1,
    HASH_TYPE_BLAKE2,
    HASH_TYPE_BLAKE3,
    HASH_TYPE_MEOW,
    COMPRESSION_TYPE_NONE,
    fourcc,
)
