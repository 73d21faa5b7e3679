"""tools/profile_torch_stages.py, the port of tools/profile_stages.py, on
the CPU: it prints a line for every step of the port's data plane, and a
fresh interpreter that runs it loads no module of jax or of the JAX
package."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "profile_torch_stages.py")


@pytest.mark.parametrize("compress", [False, True])
def test_profile_stages_prints_every_step_without_jax(compress, tmp_path):
    out = tmp_path / "steps.json"
    argv = ["--device", "cpu", "--batch-mib", "1", "--iters", "2",
            "--target-chunk-size", "512", "--out", str(out)]
    argv += ["--compress"] if compress else []
    code = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("profile_torch_stages",
                                              {TOOL!r})
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
assert tool.main({argv!r}) == 0
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'longtail_tpu'))
assert not bad, bad
print('#', '|'.join(tool.steps({compress!r})))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    steps = lines[-1][2:].split("|")
    assert len(steps) == (13 if compress else 9)
    for step in steps:
        hits = [ln for ln in lines if ln[:42].rstrip() == step]
        assert len(hits) == 1, (step, lines)
        assert "ms/batch" in hits[0] or "not measured" in hits[0]
    table = json.loads(out.read_text())
    assert table["device"] == {"name": "cpu"}
    assert list(table["steps"]) == steps
    assert table["steps"]["device busy in the full loop"] is None
    assert all(v["ms_per_batch"] > 0 for v in table["steps"].values() if v)
