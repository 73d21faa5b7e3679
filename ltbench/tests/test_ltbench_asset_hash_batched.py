"""``index_asset_hash_batched_pct.upsync`` and ``.downsync`` on spans
recorded by hand: 100 where the batch hashed every asset, the batch's
share where some assets were hashed one by one, None without spans or
without a batch span (a program older than it)."""

import time
import types

import pytest

from longtail_tpu_torch.utils import monitor
from ltbench import run

METRICS = ["index_asset_hash_batched_pct.upsync",
           "index_asset_hash_batched_pct.downsync"]


def _read(metric: str, indexes: list):
    """The metric over one window job holding one ``index`` span per
    entry of indexes: (assets, assets the batch hashed, or None)."""
    monitor.set_monitor(monitor.Monitor())
    try:
        t = time.perf_counter_ns()
        t0 = t
        for assets, batched in indexes:
            with monitor.span("index"):
                with monitor.span("index.asset_hash", assets):
                    if batched is not None:
                        monitor.record("index.asset_hash.batch", t + 1,
                                       t + 2, batched)
            t = time.perf_counter_ns()
        ctx = types.SimpleNamespace(jobs=[((t0 - 10**5) / 1e9,
                                          (t + 10**5) / 1e9, 1)],
                                    platform="cpu")
        return run.reader(metric)(ctx)
    finally:
        monitor.set_monitor(None)


@pytest.mark.parametrize("metric", METRICS)
def test_every_asset_batched_reads_100(at_root, metric):
    assert _read(metric, [(2008, 2008), (2008, 2008)]) == 100.0


@pytest.mark.parametrize("metric", METRICS)
def test_some_assets_hashed_one_by_one(at_root, metric):
    assert _read(metric, [(10, 10), (30, None)]) == 25.0


@pytest.mark.parametrize("metric", METRICS)
def test_no_batch_or_no_spans_reads_none(at_root, metric):
    assert _read(metric, [(2008, None)]) is None
    assert _read(metric, []) is None
