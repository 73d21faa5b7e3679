"""The harness finds cells, configurations, traffic and metrics by name,
refuses what does not exist, and loads nothing of JAX."""

import ast
import json
import os
import subprocess
import sys

import pytest

from ltbench import run

LTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "longtail_tpu"}


def bench():
    with open(os.path.join(os.path.dirname(LTBENCH), "BENCHMARK.json")) as f:
        return json.load(f)


def imported(path: str) -> set:
    """Top-level names of the modules a source file imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub: str = "") -> list:
    out = []
    for d, _, names in os.walk(os.path.join(LTBENCH, sub)):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return out


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(at_root, cell):
    found = run.find_cell(bench(), cell)
    assert found["cfg"]["name"] == found["cell"]["config"]
    assert found["traffic"]["job"] in ("upsync", "downsync")
    assert any(m["name"] == "setup_s" for m in found["e2e"])
    assert len(found["e2e"]) >= 2 and found["per_layer"]
    for m in found["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_every_metric_has_a_reader(at_root):
    for m in bench()["per_layer"]:
        assert os.path.exists(os.path.join(LTBENCH, "metrics",
                                           m["name"] + ".py"))


def test_unknown_workload_fails(at_root):
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "no.such-cell", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code not in (0, None)


def test_no_card_exits_without_result(at_root):
    proc = subprocess.run(
        [sys.executable, "-m", "ltbench.run", "--workload",
         "lz4.build-upsync", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=at_root,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_nothing_imports_jax():
    for path in sources():
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "longtail_tpu_torch" not in imported(path), path
        assert not imported(path) & FORBIDDEN, path


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "longtail_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
    for c in b["configs"]:
        assert os.path.exists(os.path.join(os.path.dirname(LTBENCH),
                                           c["file"]))
