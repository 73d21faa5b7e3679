"""tools/profile_torch_hufrows.py on the CPU: with no card it exits 1,
prints no result and loads no module of jax or of the JAX package; its
variant switches are the ones csrc/hufpack.cu reads."""

import importlib.util
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "profile_torch_hufrows.py")
SOURCE = os.path.join(REPO, "longtail_tpu_torch", "csrc", "hufpack.cu")


def test_profile_hufrows_refuses_the_cpu_without_jax():
    code = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("profile_torch_hufrows",
                                              {TOOL!r})
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
sys.argv = ["profile_torch_hufrows.py"]
rc = tool.main()
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'longtail_tpu'))
assert not bad, bad
sys.exit(rc)
"""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr


def test_profile_hufrows_switches_are_the_sources():
    spec = importlib.util.spec_from_file_location("profile_torch_hufrows",
                                                  TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    used = {f[2:] for flags in tool.VARIANTS.values() for f in flags}
    with open(SOURCE) as f:
        read = set(re.findall(r"#if(?:n?def)? (LT_VARIANT_\w+)", f.read()))
    assert used == read == {"LT_VARIANT_NO_LENGTHS", "LT_VARIANT_NO_PACK"}
