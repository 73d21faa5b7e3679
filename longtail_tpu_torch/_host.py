"""The host-only modules of ``longtail_tpu`` that the port reuses until
they are ported: formats, stores, the host chunker, hashers and codecs,
dedup and block writing, utils, the jax-free helpers of
``core/indexing.py``, the zstd frame and sequence helpers, and the CLI's
argument parser.

Every module named here imports jax only inside functions that the port
never calls (tests/test_torch_pipeline.py checks that importing the port
leaves jax out of ``sys.modules``).  This is the port's only import of
the ``longtail_tpu`` package.
"""

from longtail_tpu import api as host_api
from longtail_tpu import cli as host_cli
from longtail_tpu.core import indexing as host_indexing
from longtail_tpu.core import store_algebra
from longtail_tpu.core.dedup import create_missing_content
from longtail_tpu.core.write import write_content
from longtail_tpu.formats import constants
from longtail_tpu.formats.store_index import StoredBlock
from longtail_tpu.formats.version_index import VersionIndex
from longtail_tpu.ops import blake3 as host_blake3
from longtail_tpu.ops import brotli
from longtail_tpu.ops import cdc
from longtail_tpu.ops import lz4
from longtail_tpu.ops import zstd
from longtail_tpu.ops.blake2 import _PARAM0 as BLAKE2_PARAM0
from longtail_tpu.ops.blake2 import BLOCK_BYTES as BLAKE2_BLOCK_BYTES
from longtail_tpu.ops.blake2 import IV as BLAKE2_IV
from longtail_tpu.ops.blake2 import SIGMA as BLAKE2_SIGMA
from longtail_tpu.ops.compression_registry import (
    BrotliCodec as HostBrotliCodec,
    ZstdCodec as HostZstdCodec,
)
from longtail_tpu.ops.hash_registry import get_hasher
from longtail_tpu.ops.zstd_device import (
    _zstd_api,
    compress_sequences,
    sequences_from_anchors,
)
from longtail_tpu.ops.zstd_frame import (
    BLOCK_MAX,
    MAGIC,
    MAX_HUF_BITS,
    ZstdError,
    _encode_sequences,
    _pack_literals_header,
    build_huffman,
    write_huffman_weights,
)
from longtail_tpu.stores.compressblockstore import (
    _HDR as COMPRESSED_BLOCK_HEADER,
    CompressBlockStore as HostCompressBlockStore,
)
from longtail_tpu.stores.fsblockstore import FSBlockStore
from longtail_tpu.stores.storage import FSStorage
from longtail_tpu.utils import log, memtracer
from longtail_tpu.utils.detailed_progress import TerminalDetailedProgress
from longtail_tpu.utils.monitor import set_monitor
from longtail_tpu.utils.progress import null_progress

__all__ = [
    "BLAKE2_BLOCK_BYTES", "BLAKE2_IV", "BLAKE2_PARAM0", "BLAKE2_SIGMA",
    "BLOCK_MAX", "COMPRESSED_BLOCK_HEADER", "FSBlockStore", "FSStorage",
    "HostBrotliCodec", "HostCompressBlockStore", "HostZstdCodec", "MAGIC",
    "MAX_HUF_BITS",
    "StoredBlock", "TerminalDetailedProgress", "VersionIndex", "ZstdError", "_encode_sequences",
    "_pack_literals_header", "_zstd_api", "brotli", "build_huffman", "cdc",
    "compress_sequences", "constants", "create_missing_content",
    "get_hasher", "host_api", "host_blake3", "host_cli", "host_indexing",
    "log", "lz4", "memtracer", "null_progress", "sequences_from_anchors",
    "set_monitor", "store_algebra", "write_content", "write_huffman_weights",
    "zstd",
]
