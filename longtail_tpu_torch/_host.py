"""The host-only modules of ``longtail_tpu`` that the port reuses until
they are ported: formats, stores, the host chunker and hashers, dedup and
block writing, utils, the jax-free helpers of ``core/indexing.py`` and
the CLI's argument parser.

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
from longtail_tpu.ops import blake3 as host_blake3
from longtail_tpu.ops import brotli
from longtail_tpu.ops import cdc
from longtail_tpu.ops.hash_registry import get_hasher
from longtail_tpu.stores.compressblockstore import CompressBlockStore
from longtail_tpu.stores.fsblockstore import FSBlockStore
from longtail_tpu.stores.storage import FSStorage
from longtail_tpu.utils import log, memtracer
from longtail_tpu.utils.detailed_progress import TerminalDetailedProgress
from longtail_tpu.utils.monitor import set_monitor
from longtail_tpu.utils.progress import null_progress

__all__ = [
    "CompressBlockStore", "FSBlockStore", "FSStorage",
    "TerminalDetailedProgress", "brotli", "cdc", "constants",
    "create_missing_content", "get_hasher", "host_api", "host_blake3",
    "host_cli", "host_indexing", "log", "memtracer", "null_progress",
    "set_monitor", "store_algebra", "write_content",
]
