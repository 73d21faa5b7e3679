"""The reference against the program's host path on small inputs (the
reference itself imports nothing of the program; these tests may)."""

import json
import os

import numpy as np
import pytest
import torch

from ltbench import run, tree
from ltbench.reference import blake3, blocks, hpcdc, index, target

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_blake3_against_program():
    from longtail_tpu_torch.ops import blake3 as prog

    rng = np.random.default_rng(3)
    lens = [0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 3073, 65536, 70001]
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    got = blake3.hash64_bytes(msgs)
    assert [int(x) for x in got] == [prog.hash64(m) for m in msgs]
    # the empty message's published digest, af1349b9f5f9a1a6...
    assert int(got[0]) == 0xa6a1f9f5b94913af


def test_hpcdc_against_program():
    from longtail_tpu_torch.ops import cdc

    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, 3 << 20, dtype=np.uint8)
    a[1 << 20:(1 << 20) + 300000] = 0
    files = [a, np.tile(rng.integers(0, 256, 24 << 10, dtype=np.uint8), 40),
             rng.integers(0, 256, 5000, dtype=np.uint8),
             rng.integers(0, 256, 40, dtype=np.uint8)]
    flat = np.concatenate(files)
    starts = np.concatenate([[0], np.cumsum([len(f) for f in files])[:-1]])
    for target_size in (32768, 4096):
        got = hpcdc.chunk_files(torch.from_numpy(flat),
                                list(zip(starts, map(len, files))),
                                target_size)
        lo, avg, hi = hpcdc.params(target_size)
        part = target_size * 1024
        for f, g in zip(files, got):
            want = []
            for p in range(0, len(f), part):
                ends = cdc.chunk_part(f[p:p + part], lo, avg, hi)
                want += np.diff(np.concatenate([[0], ends])).tolist()
            assert g == want


# longtail's default codec: cli-lz4 with zstd at its default level
ZSTD = {"compression": "zstd", "compression_tag": 2054448178}


@pytest.mark.parametrize("config", ["cli-default-zstd", "cli-lz4"])
def test_index_and_store_against_program(tmp_path, config):
    """The reference's .lvi equals the program's host path's, and the
    program's store passes every check; a flipped byte does not.  No
    cell runs zstd yet; the reference reads its blocks all the same."""
    from longtail_tpu_torch import api
    from longtail_tpu_torch.formats import constants as C
    from longtail_tpu_torch.stores.compressblockstore import \
        CompressBlockStore
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage, MemStorage

    from ltbench import jobs

    cfg = json.load(open(os.path.join(CONFIGS, "cli-lz4.json")))
    if config == "cli-default-zstd":
        cfg.update(ZSTD)
    assert cfg["hash_identifier"] == C.HASH_TYPE_BLAKE3
    assert cfg["compression_tag"] == (
        C.COMPRESSION_TYPE_ZSTD_DEFAULT if cfg["compression"] == "zstd"
        else C.COMPRESSION_TYPE_LZ4_DEFAULT)
    spec = dict(run.TINY, paks_mib=[0.25, 0.3, 0.35, 0.4, 0.45],
                pak_ragged_mib=0.1, exact_mib=0.5)
    a, _ = tree.make(spec, 8, torch.device("cpu"))
    tree.write(a, str(tmp_path))
    mem = MemStorage()
    store = CompressBlockStore(FSBlockStore(mem, "store"))
    vi, _ = api.upsync(FSStorage(), str(tmp_path), store,
                       compression_tag=cfg["compression_tag"],
                       max_chunks_per_block=16, device=None)
    ref = index.build(a, cfg, "cpu")
    assert vi.to_bytes() == ref.lvi
    files = {f"store/{k}": v for k, v in jobs.read_all(mem, "store")[0]
             .items()}
    nums, stored = blocks.check_store(files, ref, cfg)
    assert nums == {"blocks_bad": 0, "chunks_missing": 0,
                    "chunks_stored_twice": 0, "lsi_entries_differing": 0}
    assert 0 < stored < ref.source_bytes
    path = max((k for k in files if k.endswith(".lrb")),
               key=lambda k: len(files[k]))
    blob = bytearray(files[path])
    blob[-3] ^= 0x40
    nums, _ = blocks.check_store(dict(files, **{path: bytes(blob)}), ref,
                                 cfg)
    assert nums["blocks_bad"] == 1
    del files[path]
    nums, _ = blocks.check_store(files, ref, cfg)
    assert nums["chunks_missing"] > 0 and nums["lsi_entries_differing"] > 0


def test_target_check():
    want = {"a/b.bin": np.arange(10, dtype=np.uint8),
            "c.txt": np.zeros(0, np.uint8)}
    files = {"a/b.bin": bytes(range(10)), "c.txt": b""}
    assert target.check_target(files, {"a"}, want) == {
        "target_bytes_differing": 0, "target_paths_differing": 0}
    files["a/b.bin"] = bytes(range(9)) + b"\xff"
    assert target.check_target(files, {"a", "x"}, want) == {
        "target_bytes_differing": 1, "target_paths_differing": 1}
