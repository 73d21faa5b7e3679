"""The roofline arithmetic against cases worked by hand."""

import numpy as np
import pytest
import torch

from ltbench import roofline, run, tree
from ltbench.reference import index


@pytest.mark.parametrize("size,compressions", [
    (0, 1),            # one empty block
    (1, 1), (64, 1), (65, 2), (1023, 16), (1024, 16),
    (1025, 18),        # 16 + 1 blocks, 1 parent
    (2048, 33),        # 32 blocks, 1 parent
    (3072, 50),        # 48 blocks, 2 parents
    (65536, 1087),     # 64 leaves: 1024 blocks, 63 parents
])
def test_blake3_compressions(size, compressions):
    assert roofline.blake3_compressions([size]) == compressions


def test_blake3_work():
    n_bytes, ops = roofline.blake3_work([0, 1025, 2048])
    assert n_bytes == 0 + 1025 + 2048 + 8 * 3
    assert ops == (1 + 18 + 33) * roofline.BLAKE3_OPS == 52 * 680


def test_stage1_work_and_bound():
    n_bytes, ops = roofline.stage1_work([64 << 20], np.zeros(2048))
    assert n_bytes == (64 << 20) + 4 * 2048
    assert ops == 3.5 * (64 << 20)
    ms, by = roofline.bound(n_bytes, ops)
    # 64 MiB at 3.35 TB/s is 0.02003 ms; 3.5 op/B at 16.7 Top/s 0.01371
    assert by == "bytes" and ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
    ms, by = roofline.bound(1.0, 1e9)
    assert by == "operations" and ms == pytest.approx(
        1e9 / (132 * 64 * 1.98e9) * 1e3)


def test_device_path_min():
    assert roofline.device_path_min(32768) == 512 * 1024


def test_device_chunks_from_lvi():
    spec = dict(run.TINY)
    a, _ = tree.make(spec, 2, torch.device("cpu"))
    cfg = {"target_chunk_size": 32768, "hash_identifier": 1,
           "compression_tag": 0}
    ref = index.build(a, cfg, "cpu")
    sizes, chunks = roofline.device_chunks(ref.lvi)
    big = sorted(len(v) for v in a.values() if len(v) > 512 * 1024)
    assert sorted(sizes) == big
    assert chunks.sum() == sum(big)
