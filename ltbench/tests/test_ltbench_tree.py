"""The tree generator: the same seed gives the same tree, every seed the
same sizes, and the content mix has its shares."""

import numpy as np
import pytest
import torch

from ltbench import run, tree

CPU = torch.device("cpu")


def tiny(**patch):
    spec = dict(run.TINY)
    if patch:
        spec["patch"] = dict(run.TINY_PATCH, **patch)
    return spec


def test_same_seed_same_tree():
    a1, p1 = tree.make(tiny(pak_share=0.06), 11, CPU)
    a2, p2 = tree.make(tiny(pak_share=0.06), 11, CPU)
    assert a1.keys() == a2.keys()
    assert all(np.array_equal(a1[k], a2[k]) for k in a1)
    assert [(s[0], s[1]) for s in p1.spans] == \
        [(s[0], s[1]) for s in p2.spans]


def test_every_seed_same_sizes():
    a1, p1 = tree.make(tiny(pak_share=0.06), 11, CPU)
    a2, p2 = tree.make(tiny(pak_share=0.06), (1 << 31) + 12345, CPU)
    assert sorted(map(len, a1.values())) == sorted(map(len, a2.values()))
    assert tree.tree_bytes(a1) == tree.tree_bytes(a2)
    b1, b2 = tree.apply(a1, p1), tree.apply(a2, p2)
    assert tree.tree_bytes(b1) == tree.tree_bytes(b2)
    assert sorted(len(s[3]) for s in p1.spans) == \
        sorted(len(s[3]) for s in p2.spans)
    assert any(not np.array_equal(a1[k], a2[k]) for k in a1 if len(a1[k]))


@pytest.mark.parametrize("spec_name", ["tiny", "config"])
def test_sizes(spec_name):
    import json
    import os

    spec = tiny() if spec_name == "tiny" else json.load(open(os.path.join(
        os.path.dirname(__file__), "..", "configs",
        "cli-lz4.json")))["tree"]
    lay = tree.layout(spec)
    mib = 1 << 20
    assert len(lay["paks"]) == 5
    for m, n in zip(spec["paks_mib"], lay["paks"]):
        assert m * mib - spec["pak_ragged_mib"] * mib < n <= m * mib
    assert len(lay["loose"]) == spec["loose_files"]
    assert lay["loose"].min() >= spec["loose_min_kib"] * 1024
    assert lay["loose"].max() <= spec["loose_max_kib"] * 1024
    if spec_name == "config":
        # the paks, the copy of the first, the exact file, the loose files
        total = sum(lay["paks"]) + lay["paks"][0] + 32 * mib + \
            int(lay["loose"].sum())
        assert 1.0 * (1 << 30) < total < 1.15 * (1 << 30)
        assert 140 * mib < lay["loose"].sum() < 190 * mib


def test_structure():
    a, p = tree.make(tiny(), 5, CPU)
    copy = a["content/copies/deep/pak_copy.pak"]
    assert any(k != "content/copies/deep/pak_copy.pak" and
               np.array_equal(v, copy) for k, v in a.items())
    assert len(a["content/exact.bin"]) == run.TINY["exact_mib"] * (1 << 20)
    assert len(a["content/empty_0.txt"]) == 0
    assert sum(k.startswith("content/loose/") for k in a) == \
        run.TINY["loose_files"]
    assert not (p.spans or p.replaced or p.added or p.removed)


def test_mix_shares():
    spec = dict(run.TINY, piece_mib=1)
    gen = torch.Generator().manual_seed(3)
    vocab = tree._words(gen, CPU, spec)
    data = tree.content(gen, CPU, 4 << 20, spec, vocab).reshape(4, -1)
    q = data.shape[1] // 8
    text, zeros, tile, noise = (data[:, :3 * q], data[:, 3 * q:4 * q],
                                data[:, 4 * q:5 * q], data[:, 5 * q:])
    assert not zeros.any()
    letters = (text == 32) | ((text >= 97) & (text <= 122))
    assert letters.all() and (text == 32).mean() > 0.05
    period = spec["tile_kib"] * 1024
    assert np.array_equal(tile[:, :period], tile[:, period:2 * period])
    # noise: about uniform bytes
    assert 100 < noise.mean() < 155 and len(np.unique(noise)) == 256


def test_patch_shares():
    a, p = tree.make(tiny(), 9, CPU)
    a, p = tree.make(dict(tiny(), patch=run.TINY_PATCH), 9, CPU)
    paks = [k for k in a if k.endswith(".pak") and "copies" not in k]
    edited = sum(len(s[3]) for s in p.spans)
    share = run.TINY_PATCH["pak_share"]
    assert share <= edited / sum(len(a[k]) for k in paks) < 2 * share
    assert len(p.replaced) == run.TINY_PATCH["loose_replaced"]
    assert len(p.added) == run.TINY_PATCH["loose_added"]
    assert len(p.removed) == run.TINY_PATCH["loose_removed"]
    b = tree.apply(a, p)
    for path, off, old, new in p.spans:
        assert np.array_equal(a[path][off:off + len(old)], old)
        assert np.array_equal(b[path][off:off + len(new)], new)
    assert np.array_equal(b["content/copies/deep/pak_copy.pak"],
                          a["content/copies/deep/pak_copy.pak"])


def test_disk_patch_matches_memory(tmp_path):
    a, p = tree.make(dict(tiny(), patch=run.TINY_PATCH), 4, CPU)
    b = tree.apply(a, p)
    tree.write(a, str(tmp_path))
    tree.write_patch(p, str(tmp_path))
    on_disk = {}
    for f in tmp_path.rglob("*"):
        if f.is_file():
            on_disk[str(f.relative_to(tmp_path))] = f.read_bytes()
    assert on_disk.keys() == b.keys()
    assert all(on_disk[k] == b[k].tobytes() for k in b)
