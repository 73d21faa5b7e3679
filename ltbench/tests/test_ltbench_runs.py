"""Whole runs on the CPU at a small tree (the kernels' plain versions):
every cell comes out correct, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have.
The control (the reference in the program's place, one guarantee
broken) comes out not correct too.  One cell runs on the card where
there is one."""

import json

import pytest

from ltbench import control, run

CELLS = ["lz4.build-upsync", "lz4.patch-upsync", "lz4.patch-downsync"]
# a cell that BENCHMARK.json does not hold yet, over a traffic file that
# is there: an upsync into a store that holds the version before
PATCH_UPSYNC = {"name": "lz4.patch-upsync", "config": "cli-lz4",
                "traffic": "patch-upsync", "chips": 1,
                "why": "upsyncs of version N+1 into a store holding N"}


@pytest.fixture
def cells(monkeypatch):
    """BENCHMARK.json as the harness reads it, with PATCH_UPSYNC added."""
    real = run.load_json

    def load(rel):
        out = real(rel)
        if rel == "BENCHMARK.json":
            out["workloads"].append(dict(PATCH_UPSYNC))
            for m in out["end_to_end"] + out["per_layer"]:
                if "lz4.build-upsync" in m.get("workloads", []):
                    m["workloads"].append(PATCH_UPSYNC["name"])
        return out

    monkeypatch.setattr(run, "load_json", load)


def one_run(capsys, cell, seed, device="cpu"):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0",
            "--trace", "0", "--device", device, "--tiny"]
    assert run.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct(at_root, cells, capsys, cell):
    out = one_run(capsys, cell, (1 << 31) + 7)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert "setup_s" in out["metrics"]


def _odd_blocks(fn, count_of):
    def half(*args, **kwargs):
        kwargs["block_indexes"] = range(1, count_of(args), 2)
        return fn(*args, **kwargs)
    return half


def _unchanged(*args, **kwargs):
    return None


def _flip_raw(fn):
    from longtail_tpu_torch.formats.store_index import StoredBlock

    def flipped(stored_block, *args, **kwargs):
        data = bytearray(stored_block.block_data)
        data[len(data) // 2] ^= 1
        return fn(StoredBlock(block_index=stored_block.block_index,
                              block_data=bytes(data)), *args, **kwargs)
    return flipped


def _every_other_write(fn):
    calls = []

    def half(self, path, total_size, ranges):
        calls.append(path)
        return fn(self, path, total_size, ranges if len(calls) % 2 else [])
    return half


def _flip_written(fn):
    def flipped(self, path, total_size, ranges):
        if ranges:
            off, data = ranges[0]
            data = bytearray(data)
            if data:
                data[len(data) // 2] ^= 1
            ranges = [(off, bytes(data))] + list(ranges[1:])
        return fn(self, path, total_size, ranges)
    return flipped


def fault(monkeypatch, kind: str, job: str):
    from longtail_tpu_torch import api
    from longtail_tpu_torch.stores import compressblockstore as cbs

    if job == "upsync":
        name = "write_content"
        if kind == "unchanged":
            monkeypatch.setattr(api, name, _unchanged)
        elif kind == "half":
            monkeypatch.setattr(api, name, _odd_blocks(
                api.write_content, lambda a: a[2].block_count))
        else:
            monkeypatch.setattr(cbs, "compress_block",
                                _flip_raw(cbs.compress_block))
    else:
        name = "change_version"
        if kind == "unchanged":
            monkeypatch.setattr(api, name, _unchanged)
        else:
            # the client folder's writes: half of them left out, or one
            # byte of each altered
            from longtail_tpu_torch.stores.storage import MemStorage

            wrap = _every_other_write if kind == "half" else _flip_written
            monkeypatch.setattr(MemStorage, "write_ranges",
                                wrap(MemStorage.write_ranges))


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["lz4.build-upsync",
                                  "lz4.patch-downsync"])
def test_fault_not_correct(at_root, capsys, monkeypatch, cell, kind):
    from ltbench import jobs

    job = "upsync" if "upsync" in cell else "downsync"
    real_setup = jobs.Jobs.setup

    def setup_then_break(self):
        real_setup(self)
        fault(monkeypatch, kind, job)

    monkeypatch.setattr(jobs.Jobs, "setup", setup_then_break)
    out = one_run(capsys, cell, 21)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["lz4.patch-upsync", "lz4.patch-downsync"])
def test_fault_in_earlier_job_not_correct(at_root, cells, capsys,
                                          monkeypatch, cell):
    """Only the set-up's job is broken; the window's job, which writes
    the same store or client folder anew, is sound."""
    from ltbench import jobs

    real_job = jobs.Jobs.job

    def job(self, k):
        if k:
            return real_job(self, k)
        with pytest.MonkeyPatch.context() as mp:
            fault(mp, "altered", "upsync" if "upsync" in cell
                  else "downsync")
            return real_job(self, k)

    monkeypatch.setattr(jobs.Jobs, "job", job)
    out = one_run(capsys, cell, 23)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct(at_root, cells, cell):
    checks = control.control(cell, 5, "cpu", True)
    assert any(v > 0 for v in checks.values()), checks


@pytest.mark.card
def test_cell_on_card(at_root, capsys, card):
    out = one_run(capsys, "lz4.build-upsync", 3, "cuda")
    assert out["correct"] and out["device"]["platform"] == "gpu"
