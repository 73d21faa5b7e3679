"""bench_torch.py, the port's benchmark harness, on the CPU: each of its
nine modes at small sizes returns the keys of bench.py's dict for that
mode (read from bench.py's source with ast; bench.py imports jax and is
never imported here) and runs every check of its path; its copies of
bench.py's corpus helpers are byte-identical; device_entropy builds its
code table from every stream; it imports neither jax nor the JAX
package; and it refuses --device cuda without a card."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from longtail_tpu_torch.ops import entropy_kernel, zstd_device, zstd_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20


def _functions(path: str) -> dict:
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


BENCH = _functions(os.path.join(REPO, "bench.py"))
PORT = _functions(os.path.join(REPO, "bench_torch.py"))


def _walk(stmts, branches: dict, keys: set, checks: set) -> str | None:
    """Follow a function body as it runs with the `if` tests decided by
    branches (ast.unparse(test) -> bool): collect the keys put into its
    result dict and the lines of its check() calls.  Returns "return" or
    "raise" where the path ends.  An `if` not in branches may only guard
    code that holds neither."""
    for s in stmts:
        if isinstance(s, ast.If):
            test = ast.unparse(s.test)
            if test in branches:
                end = _walk(s.body if branches[test] else s.orelse,
                            branches, keys, checks)
                if end:
                    return end
                continue
            k, c = set(), set()
            _walk(s.body, branches, k, c)
            _walk(s.orelse, branches, k, c)
            if k or c:
                raise KeyError(f"undecided branch: {test}")
            continue
        if isinstance(s, ast.Return):
            if isinstance(s.value, ast.Dict):
                keys.update(k.value for k in s.value.keys)
            return "return"
        if isinstance(s, ast.Raise):
            return "raise"
        for node in ast.walk(s):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name) and f.id == "check":
                    checks.add(node.lineno)
                elif isinstance(f, ast.Attribute) and f.attr == "update" \
                        and isinstance(node.args[0], ast.Dict):
                    keys.update(k.value for k in node.args[0].keys)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Dict):
                keys.update(k.value for k in node.value.keys)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Store) and \
                    isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
        if isinstance(s, (ast.Try, ast.With)):
            end = _walk(s.body, branches, keys, checks)
            if end:
                return end
    return None


def _branches(with_compress: bool = False, path_exists: bool = True) -> dict:
    zstd_api = zstd_device._zstd_api() is not None
    return {"with_compress": with_compress, "verify": True,
            "ch is not None": with_compress,
            "zstd_device._zstd_api() is not None": zstd_api,
            "_z._load_native() is not None": bench_torch._z._load_native()
            is not None,
            "not os.path.isdir(path)": not path_exists}


def _keys(funcs: dict, name: str, branches: dict) -> set:
    keys: set = set()
    _walk(funcs[name].body, branches, keys, set())
    return keys


def _check_lines(names, branches: dict) -> set:
    lines: set = set()
    for name in names:
        _walk(PORT[name].body, branches, set(), lines)
    return lines


def _tree(root, sizes):
    os.makedirs(root)
    for i, n in enumerate(sizes):
        bench_torch.make_corpus(n, seed=i).tofile(
            os.path.join(root, f"f{i}.bin"))
    return str(root)


# mode: (bench.py's function, with_compress, port call at a small size,
# the port functions whose checks run)
MODES = {
    "chunk_hash_compress": ("bench_data_plane", True, lambda tmp: (
        bench_torch.bench_data_plane(MIB, 512, True, "cpu", batch_mib=1,
                                     block_bytes=256 << 10,
                                     warmup_batches=1)),
        ("bench_data_plane", "verify_data_plane")),
    "chunk_hash": ("bench_data_plane", False, lambda tmp: (
        bench_torch.bench_data_plane(MIB, 512, False, "cpu", batch_mib=1,
                                     warmup_batches=1)),
        ("bench_data_plane", "verify_data_plane")),
    "mesh_chunk_hash": ("bench_mesh_chunk_hash", False, lambda tmp: (
        bench_torch.bench_mesh_chunk_hash(MIB, 512, "cpu",
                                          batch_bytes_per_dev=MIB // 2,
                                          warmup_batches=1)),
        ("bench_mesh_chunk_hash",)),
    "compress": ("bench_compress", False, lambda tmp: (
        bench_torch.bench_compress(3 * MIB, "cpu")), ("bench_compress",)),
    "device_compress": ("bench_device_compress", False, lambda tmp: (
        bench_torch.bench_device_compress(2 * MIB, "cpu", batch_bytes=MIB,
                                          block_bytes=256 << 10)),
        ("bench_device_compress",)),
    "device_decode": ("bench_device_decode", False, lambda tmp: (
        bench_torch.bench_device_decode(0, "cpu", block_bytes=128 << 10)),
        ("bench_device_decode",)),
    "device_entropy": ("bench_device_entropy", False, lambda tmp: (
        bench_torch.bench_device_entropy(0, "cpu", streams=8,
                                         stream_bytes=16 << 10,
                                         block_bytes=256 << 10)),
        ("bench_device_entropy",)),
    "downsync": ("bench_downsync", False, lambda tmp: (
        bench_torch.bench_downsync(2 * MIB + 4097, "cpu", file_bytes=MIB,
                                   target_chunk_size=512)),
        ("bench_downsync",)),
    "real": ("bench_real_data", False, lambda tmp: (
        bench_torch.bench_real_data(0, _tree(tmp / "tree", (
            300000, 70000, 5000, 0, MIB)), "cpu", target_chunk_size=512)),
        ("bench_real_data",)),
}


def test_modes_are_bench_pys():
    assert set(MODES) == set(bench_torch.MODES)
    choices = [n for n in ast.walk(BENCH["main"]) if isinstance(n, ast.keyword)
               and n.arg == "choices"]
    assert set(ast.literal_eval(choices[0].value)) == set(MODES)


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_returns_bench_pys_keys(mode, tmp_path, monkeypatch):
    """The mode on the CPU at a small size: exactly bench.py's keys for
    that mode plus device, verified where bench.py verifies, and every
    check() of its path executed."""
    fn, with_compress, call, port_fns = MODES[mode]
    branches = _branches(with_compress)
    ran = set()
    check = bench_torch.check

    def counted(ok, msg):
        ran.add(sys._getframe(1).f_lineno)
        check(ok, msg)

    monkeypatch.setattr(bench_torch, "check", counted)
    result = call(tmp_path)
    result["device"] = bench_torch.device_info("cpu")
    got = json.loads(json.dumps(result))
    assert set(got) == _keys(BENCH, fn, branches) | {"device"}
    assert set(got) - {"device"} == _keys(PORT, fn, branches)
    assert got["device"] == {"name": "cpu"}
    if "verified" in got:
        assert got["verified"] is True
    assert got["value"] >= 0 and np.isfinite(got["value"])
    assert ran == _check_lines(port_fns, branches)


def test_real_skips_an_absent_path(tmp_path):
    got = bench_torch.bench_real_data(0, str(tmp_path / "absent"), "cpu")
    assert got["skipped"] is True
    assert set(got) == _keys(BENCH, "bench_real_data",
                             _branches(path_exists=False))


@pytest.mark.parametrize("seed", [7, 3])
def test_corpus_helpers_equal_bench_pys(seed):
    """make_corpus and structured_rows against bench.py's own numpy
    source, taken from the file with ast."""
    ns = {"np": np}
    for name in ("make_corpus", "structured_rows"):
        exec(compile(ast.Module([BENCH[name]], []), "bench.py", "exec"), ns)
    n = 3 * MIB + 12345
    assert np.array_equal(bench_torch.make_corpus(n, seed),
                          ns["make_corpus"](n, seed))
    base = np.random.default_rng(seed).integers(0, 256, (3 * 256, 128),
                                                dtype=np.uint8)
    assert np.array_equal(bench_torch.structured_rows(base, np),
                          ns["structured_rows"](base, np))


def test_device_entropy_table_is_built_from_every_stream(monkeypatch):
    """The code table handed to the pack equals build_huffman over the
    histogram of all the resident streams, which here differs from the
    table of their first 4 (bench.py:609-612 takes 4)."""
    seen = []

    class Stop(Exception):
        pass

    def capture(lits, n_lit, table):
        seen.append((lits.numpy().copy(), table.numpy().copy()))
        raise Stop

    monkeypatch.setattr(entropy_kernel, "hufpack", capture)
    with pytest.raises(Stop):
        bench_torch.bench_device_entropy(0, "cpu", streams=8,
                                         stream_bytes=64 << 10)
    (lits, table), = seen

    def table_of(rows):
        _, cv, cl = zstd_frame.build_huffman(
            np.bincount(rows.reshape(-1), minlength=256).tolist())
        return entropy_kernel.pack_code_table(cv, cl)

    assert lits.shape == (8, 64 << 10)
    assert np.array_equal(table, table_of(lits))
    assert not np.array_equal(table, table_of(lits[:4]))


def test_import_leaves_jax_out():
    """import bench_torch in a fresh interpreter (tests/conftest.py
    imports jax in this process) loads no module of jax or of the JAX
    package."""
    code = ("import sys, bench_torch\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'longtail_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'longtail_tpu_torch.parallel.pipeline' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)


def test_cuda_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    p = subprocess.run(
        [sys.executable, "bench_torch.py", "--mode", "compress", "--gib",
         "0.001"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA is not available" in p.stderr


def test_main_prints_one_json_line_on_the_cpu():
    """python bench_torch.py --device cpu at a small target chunk size:
    stdout is one JSON line with bench.py's chunk_hash keys and device."""
    p = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu", "--mode",
         "chunk_hash", "--gib", "0.001", "--target-chunk-size", "512",
         "--batch-mib", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True)
    line, = p.stdout.splitlines()
    got = json.loads(line)
    assert set(got) == _keys(BENCH, "bench_data_plane", _branches()) | {
        "device"}
    assert got["device"] == {"name": "cpu"} and got["verified"] is True
    assert "warmup: " in p.stderr and "verify: " in p.stderr
