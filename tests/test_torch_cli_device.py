"""The port's CLI ``downsync`` and ``unpack`` over a stale target with
``--device host`` and ``--device cpu``: each rebuilds the tree the JAX
CLI's command rebuilds from the same store or archive; without a card a
bare or absent ``--device`` raises and leaves the target as it was."""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from longtail_tpu import cli as jcli  # noqa: E402
from longtail_tpu_torch import cli  # noqa: E402

FILES = [("a.bin", 70000), ("sub/b.txt", 3000), ("sub/c.bin", 20000),
         ("empty", 0)]


def _files(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for n in files:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """A tree, its store and .lvi (upsync --device host) and its archive
    (pack --device host); returns (base, src)."""
    base = str(tmp_path_factory.mktemp("cli_device"))
    src = os.path.join(base, "src")
    rng = np.random.default_rng(21)
    for path, size in FILES:
        os.makedirs(os.path.dirname(os.path.join(src, path)), exist_ok=True)
        with open(os.path.join(src, path), "wb") as f:
            f.write(rng.integers(0, 256, size, np.uint8).tobytes())
    for argv in (["upsync", "--storage-uri", f"{base}/store",
                  "--source-path", src, "--target-path", f"{base}/v.lvi"],
                 ["pack", "--source-path", src, "--target-path",
                  f"{base}/v.la"]):
        assert cli.main(["--workers", "1", *argv, "--target-chunk-size",
                         "1024", "--device", "host"]) == 0
    return base, src


def _stale(src, target) -> None:
    """target holds one file of the version unchanged and one changed."""
    for name in ("sub/b.txt", "a.bin"):
        os.makedirs(os.path.dirname(os.path.join(target, name)),
                    exist_ok=True)
        shutil.copyfile(os.path.join(src, name), os.path.join(target, name))
    with open(os.path.join(target, "a.bin"), "r+b") as f:
        f.seek(1000)
        f.write(b"stale")


def _argv(command, base, target) -> list:
    if command == "downsync":
        return ["downsync", "--storage-uri", f"{base}/store",
                "--source-path", f"{base}/v.lvi", "--target-path", target]
    return ["unpack", "--source-path", f"{base}/v.la", "--target-path",
            target]


@pytest.mark.parametrize("device", ["host", "cpu"])
@pytest.mark.parametrize("command", ["downsync", "unpack"])
def test_stale_target_equals_the_jax_cli(made, tmp_path, command, device):
    base, src = made
    port, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    _stale(src, port)
    _stale(src, jax_out)
    assert cli.main(["--workers", "1", *_argv(command, base, port),
                     "--device", device]) == 0
    # the JAX CLI's downsync defaults to 80, which fails over a stale
    # target; the port's and the reference C's default is 0
    extra = ["--min-block-usage-percent", "0"] if command == "downsync" \
        else []
    assert jcli.main(["--workers", "1", *_argv(command, base, jax_out),
                      *extra]) == 0
    assert _files(port) == _files(jax_out) == _files(src)


@pytest.mark.parametrize("flag", [[], ["--device"], ["--device", "cuda"]],
                         ids=["absent", "bare", "cuda"])
@pytest.mark.parametrize("command", ["downsync", "unpack"])
def test_stale_target_without_a_card_raises(made, tmp_path, command, flag):
    """The card is the default, bare or absent: the target scan raises
    and nothing runs on the CPU in its place."""
    base, src = made
    target = str(tmp_path / "t")
    _stale(src, target)
    before = _files(target)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--workers", "1", *_argv(command, base, target), *flag])
    assert _files(target) == before
