"""The host utilities of tests/test_jobgraph.py, tests/test_memtracer.py
and tests/test_monitor.py held between the JAX package and the port:
JobGraph's order, results, channels, errors and suspend/resume; the
memtracer's context rows (the library and the CLI's --mem-tracer); the
monitor's event sequence over an upsync and a downsync, and the detailed
progress line it drives.  Each scenario runs in both packages and
returns what it observed, which must be equal."""

import io
import re
import threading
import time

import numpy as np
import pytest
import torch

from tests.torch_sides import PORT, downsync, same, upsync

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# JobGraph (test_jobgraph.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4])
def test_dependencies_order_and_results(workers):
    """A diamond a, b -> c -> d: results, and every job after its
    dependencies; with one worker the whole order, equal in both."""
    def scenario(side):
        order = []
        lock = threading.Lock()

        def mk(name, val):
            def fn():
                with lock:
                    order.append(name)
                return val
            return fn

        g = side.jobgraph.JobGraph(workers=workers)
        a = g.add(mk("a", 1))
        b = g.add(mk("b", 2))
        c = g.add(mk("c", 3), deps=[a, b])
        d = g.add(mk("d", 4), deps=[c])
        g.run()
        assert order.index("c") > max(order.index("a"), order.index("b"))
        assert order.index("d") > order.index("c")
        return ([g.result(j) for j in (a, b, c, d)],
                order if workers == 1 else sorted(order))

    assert same(scenario)[0] == [1, 2, 3, 4]


def test_channels_run_concurrently():
    """A channel-1 job that waits for a channel-0 job sees it run: the
    channels overlap (the JAX test's event; its wall bound is left out,
    six workers share the machine)."""
    def scenario(side):
        hit = threading.Event()

        def slow():
            return "slow", hit.wait(30)

        def fast():
            hit.set()
            return "fast"

        g = side.jobgraph.JobGraph(workers={0: 1, 1: 1})
        s = g.add(slow, channel=1)
        f = g.add(fast, channel=0)
        g.run()
        return g.result(s), g.result(f)

    assert same(scenario) == (("slow", True), "fast")


def test_first_error_cancels_group():
    def scenario(side):
        ran = []

        def boom():
            raise RuntimeError("job failed")

        def late():
            time.sleep(0.01)
            ran.append(1)

        g = side.jobgraph.JobGraph(workers=1)
        g.add(boom)
        for _ in range(50):
            g.add(late)
        with pytest.raises(RuntimeError) as ei:
            g.run()
        return str(ei.value), len(ran)

    assert same(scenario) == ("job failed", 0)


def test_suspend_resume():
    """A job parks on an async completion and finishes with the delivered
    payload; its dependent runs after the resume."""
    def scenario(side):
        resumes = []

        def async_put(register):
            def complete():
                time.sleep(0.05)
                resumes.append(1)
                register("payload-42")
            threading.Thread(target=complete, daemon=True).start()

        def job(resumed=None):
            if resumed is None:
                return side.jobgraph.Suspend(lambda cb: async_put(cb))
            return resumed

        g = side.jobgraph.JobGraph(workers=2)
        j = g.add(job)
        after = g.add(lambda: "after", deps=[j])
        g.run()
        return g.result(j), g.result(after), resumes

    assert same(scenario) == ("payload-42", "after", [1])


# ---------------------------------------------------------------------------
# memtracer (test_memtracer.py)
# ---------------------------------------------------------------------------

def test_context_attribution_and_peak():
    """The rows: phase_a keeps 1 MiB, phase_b frees its 4 MiB but peaks
    at it; the counts and which rows meet those bounds, in both."""
    def scenario(side):
        mt = side.memtracer
        mt.install()
        mt.reset()
        try:
            keep = []
            with mt.context("phase_a"):
                keep.append(np.zeros(1 << 20, dtype=np.uint8))
            with mt.context("phase_b"):
                tmp = np.zeros(4 << 20, dtype=np.uint8)
                del tmp
            a, b = mt.stats("phase_a"), mt.stats("phase_b")
            summary = mt.dump_stats()
            return ((a.count, a.mem >= 1 << 20), (b.count, b.peak >= 4 << 20,
                                                 abs(b.mem) < 1 << 19),
                    mt.global_peak() >= 4 << 20,
                    [line.split()[0] for line in summary.splitlines()])
        finally:
            mt.uninstall()

    assert same(scenario) == ((1, True), (1, True, True), True,
                              ["context", "phase_a", "phase_b", "global"])


def test_noop_when_not_installed():
    def scenario(side):
        side.memtracer.reset()
        with side.memtracer.context("dark"):
            pass
        return side.memtracer.stats("dark").count

    assert same(scenario) == 0


def test_csv_dump(tmp_path):
    def scenario(side):
        mt = side.memtracer
        mt.install()
        mt.reset()
        try:
            with mt.context("csv_phase"):
                _ = bytearray(1 << 16)
            out = tmp_path / f"{side.name}.csv"
            mt.dump_stats(str(out))
            return [";".join(line.split(";")[:2])
                    for line in out.read_text().splitlines()]
        finally:
            mt.uninstall()

    assert same(scenario) == ["context;count", "csv_phase;1"]


def test_cli_mem_tracer_flag(tmp_path, capsys):
    """--mem-tracer on an upsync prints the same context rows (name and
    count) from both CLIs; the port's runs with --device cpu."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.bin").write_bytes(np.random.default_rng(0).integers(
        0, 256, 1 << 16, dtype=np.uint8).tobytes())

    def scenario(side):
        out = tmp_path / side.name
        device = ["--device", "cpu"] if side is PORT else []
        rc = side.cli.main(["--mem-tracer", "upsync",
                            "--storage-uri", str(out / "store"),
                            "--source-path", str(src),
                            "--target-path", str(out / "v.lvi"), *device])
        err = capsys.readouterr().err
        rows = err[err.index("context"):].splitlines()
        return (rc, [tuple(r.split()[:2]) for r in rows[1:-1]],
                rows[-1].split(":")[0], (out / "v.lvi").read_bytes())

    rc, rows, last, _ = same(scenario)
    assert rc == 0 and ("ChunkAssets", "1") in rows and last == "global peak"


# ---------------------------------------------------------------------------
# the monitor (test_monitor.py)
# ---------------------------------------------------------------------------

def test_monitor_sees_full_lifecycle():
    """The events of an upsync and a downsync (workers=1), name and
    arguments in order, are the same in both packages."""
    def scenario(side):
        storage = side.storage.MemStorage()
        storage.create_dir("src")
        rng = np.random.default_rng(2)
        for i in range(3):
            storage.write(f"src/f{i}", rng.integers(0, 256, 9000,
                                                    np.uint8).tobytes())
        store = side.compressblockstore.CompressBlockStore(
            side.fsblockstore.FSBlockStore(storage, "store"))
        events = []

        class Recorder(side.monitor.Monitor):
            def __getattribute__(self, name):
                if name.startswith("_"):
                    return object.__getattribute__(self, name)
                return lambda *a: events.append((name, a))

        side.monitor.set_monitor(Recorder())
        try:
            vi, _ = upsync(side, storage, "src", store,
                           target_chunk_size=2048, workers=1)
            downsync(side, store, storage, "out", vi, workers=1)
        finally:
            side.monitor.set_monitor(None)
        written = sum(a[2] for n, a in events if n == "asset_write")
        assert written == sum(len(storage.read(f"src/f{i}"))
                              for i in range(3))
        return events

    names = {n for n, _ in same(scenario)}
    assert names >= {"block_prepare", "block_save", "block_save_complete",
                     "version_begin", "block_load", "block_load_complete",
                     "block_compose", "asset_write", "version_end"}


def test_detailed_progress_renders():
    """The terminal line of a version's events, its clock and rate left
    out: the same counts in both."""
    def scenario(side):
        buf = io.StringIO()
        mon = side.detailed_progress.TerminalDetailedProgress(
            out=buf, interval=0.0)
        mon.version_begin(3, 10)
        mon.block_load(0, 123, 0)
        mon.block_load_complete(0, 123)
        mon.asset_write(1, 0, 5000)
        mon.version_end()
        return re.sub(r"\[ *[\d.]+s\]|\([\d.]+ MB/s\)", "", buf.getvalue())

    out = same(scenario)
    assert "blocks loaded 1" in out and "MB" in out
