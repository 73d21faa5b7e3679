"""A seeded asset tree, such as a game build, and a seeded patch of it.

The pattern is ``chip_smoke.py`` ``make_tree``/``structured``
(chip_smoke.py:214-263, frozen here and changed): paks with ragged ends in
nested folders, a byte-identical copy of one pak, one file of an exact
part size, loose files that take the host path, one empty file.  The
content mix is new.  Every 8 MiB piece of content holds, in order, text
(words drawn from a seeded vocabulary with Zipf frequencies, so it
compresses but does not repeat at chunk scale), zeros (padding), repeats
of one random tile (duplicated content) and noise (media that is already
compressed), in the shares the configuration gives.

Every seed gets the same file sizes, the same patch spans and the same
loose-file edits by size; the seed decides which path gets which size,
where the spans lie and what the bytes are.  So the work of a job is the
same for every seed.

Content is made with a ``torch.Generator`` on the run's device, in a few
large calls, and kept on the host as numpy arrays: the tree held in
memory is the raw data that the program and the reference both read.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

MIB = 1 << 20
KIB = 1 << 10

# the seed of every size list: fixed, so that all seeds share them
SIZES_SEED = 20260417


@dataclasses.dataclass
class Patch:
    """What turns version A of a tree into version B."""
    spans: list          # (path, offset, old bytes, new bytes)
    replaced: list       # (path, old bytes, new bytes)
    added: list          # (path, new bytes)
    removed: list        # (path, old bytes)


def _words(gen: torch.Generator, device, spec: dict):
    """The vocabulary: (V, 16) uint8 letters followed by one space, the
    lengths with the space, and the cumulative Zipf weights."""
    v = int(spec["vocabulary"])
    lens = torch.randint(2, 11, (v,), generator=gen, device=device)
    letters = torch.randint(97, 123, (v, 16), generator=gen, device=device,
                            dtype=torch.uint8)
    col = torch.arange(16, device=device)[None, :]
    letters = torch.where(col == lens[:, None], torch.tensor(
        32, dtype=torch.uint8, device=device), letters)
    rank = torch.arange(1, v + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(rank.pow(-float(spec["zipf"])), 0)
    return letters, lens + 1, (cdf / cdf[-1]).to(torch.float32)


def _text(gen, device, n_bytes: int, vocab) -> torch.Tensor:
    """n_bytes of words, made 16 MiB at a time."""
    letters, lens, cdf = vocab
    mean = float((lens.double() * torch.diff(
        cdf.double(), prepend=cdf.new_zeros(1).double())).sum())
    out = []
    step = 16 * MIB
    for lo in range(0, n_bytes, step):
        n = min(step, n_bytes - lo)
        m = int(n / mean * 1.25) + 64
        while True:
            ids = torch.searchsorted(cdf, torch.rand(m, generator=gen,
                                                     device=device))
            ids = ids.clamp_(max=len(lens) - 1)
            wl = lens[ids]
            if int(wl.sum()) >= n:
                break
            m *= 2
        ends = torch.cumsum(wl, 0)
        keep = int(torch.searchsorted(ends, torch.tensor(
            n, device=device))) + 1
        ids, wl = ids[:keep], wl[:keep]
        word = torch.repeat_interleave(torch.arange(keep, device=device), wl)
        pos = torch.arange(len(word), device=device) - \
            (torch.cumsum(wl, 0) - wl)[word]
        out.append(letters[ids[word], pos][:n])
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.uint8,
                                                  device=device)


def content(gen, device, n_bytes: int, spec: dict, vocab) -> np.ndarray:
    """n_bytes of the mix: each piece is text, zeros, tile repeats, noise."""
    piece = int(spec["piece_mib"] * MIB)
    mix = spec["mix"]
    total = sum(mix.values())
    share = {k: piece * int(mix[k]) // total for k in mix}
    share["noise"] = piece - share["text"] - share["zeros"] - share["tile"]
    n_pieces = max(1, -(-n_bytes // piece))
    text = _text(gen, device, n_pieces * share["text"], vocab)
    tile_b = int(spec["tile_kib"] * KIB)
    tiles = torch.randint(0, 256, (n_pieces, tile_b), generator=gen,
                          device=device, dtype=torch.uint8)
    reps = -(-share["tile"] // tile_b)
    tiled = tiles.repeat(1, reps)[:, :share["tile"]]
    noise = torch.randint(0, 256, (n_pieces, share["noise"]), generator=gen,
                          device=device, dtype=torch.uint8)
    zeros = torch.zeros((n_pieces, share["zeros"]), dtype=torch.uint8,
                        device=device)
    out = torch.cat([text.view(n_pieces, -1), zeros, tiled, noise], 1)
    return out.reshape(-1)[:n_bytes].cpu().numpy()


def log_uniform(rng, n: int, lo: int, hi: int) -> np.ndarray:
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)


def layout(spec: dict) -> dict:
    """Every size of the tree and of its patch, the same for every seed."""
    rng = np.random.default_rng(SIZES_SEED)
    ragged = int(spec["pak_ragged_mib"] * MIB)
    paks = [int(m * MIB) - (i * 1234567 + 4321) % ragged
            for i, m in enumerate(spec["paks_mib"])]
    loose = log_uniform(rng, int(spec["loose_files"]),
                        int(spec["loose_min_kib"] * KIB),
                        int(spec["loose_max_kib"] * KIB))
    p = spec.get("patch", {"pak_share": 0, "span_min_kib": 64,
                           "span_max_kib": 64, "loose_replaced": 0,
                           "loose_added": 0, "loose_removed": 0})
    spans = []
    for size in paks:
        want = int(size * p["pak_share"])
        sizes = []
        while sum(sizes) < want:
            sizes.append(int(log_uniform(rng, 1, int(p["span_min_kib"] * KIB),
                                         int(p["span_max_kib"] * KIB))[0]))
        spans.append(sizes)
    order = np.argsort(loose, kind="stable")
    n_rep, n_rem = int(p["loose_replaced"]), int(p["loose_removed"])
    picks = rng.choice(len(loose), n_rep + n_rem, replace=False)
    added = log_uniform(rng, int(p["loose_added"]),
                        int(spec["loose_min_kib"] * KIB),
                        int(spec["loose_max_kib"] * KIB))
    return {"paks": paks, "loose": loose, "spans": spans,
            "replaced_ranks": order[picks[:n_rep]],
            "removed_ranks": order[picks[n_rep:]], "added": added}


def pak_path(i: int) -> str:
    return f"content/level{i % 2}/group{i}/pak_{i}.pak"


def loose_path(k: int) -> str:
    return f"content/loose/d{k % 16:02d}/f{k:04d}.dat"


def make(spec: dict, seed: int, device) -> tuple[dict, Patch]:
    """(tree, patch): tree maps each file's path to its bytes (version A);
    the patch is drawn from the same seed."""
    lay = layout(spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    rng = np.random.default_rng(int(seed) % (1 << 63))
    vocab = _words(gen, device, spec)
    tree: dict[str, np.ndarray] = {}
    paks = lay["paks"]
    where = rng.permutation(len(paks))      # pak i gets size paks[where[i]]
    for i, j in enumerate(where):
        tree[pak_path(i)] = content(gen, device, paks[j], spec, vocab)
    # the copy is always of the pak of the first listed size
    src = pak_path(int(np.flatnonzero(where == 0)[0]))
    tree["content/copies/deep/pak_copy.pak"] = tree[src]
    tree["content/exact.bin"] = content(
        gen, device, int(spec["exact_mib"] * MIB), spec, vocab)
    loose = lay["loose"]
    size_of = rng.permutation(len(loose))   # loose file k has loose[size_of[k]]
    stream = content(gen, device, int(loose.sum()), spec, vocab)
    ends = np.cumsum(loose[size_of])
    for k in range(len(loose)):
        tree[loose_path(k)] = stream[ends[k] - loose[size_of[k]]:ends[k]]
    for e in range(int(spec["empty_files"])):
        tree[f"content/empty_{e}.txt"] = np.zeros(0, np.uint8)

    spans = []
    for i, j in enumerate(where):
        path, size = pak_path(i), paks[j]
        sizes = lay["spans"][j]
        if not sizes:
            continue
        zone = size // len(sizes)
        new = content(gen, device, int(sum(sizes)), spec, vocab)
        at = 0
        for z, n in enumerate(sizes):
            n = min(n, zone)
            off = z * zone + int(rng.integers(0, zone - n + 1))
            spans.append((path, off, tree[path][off:off + n].copy(),
                          new[at:at + n]))
            at += n
    rank_of = np.argsort(size_of)           # size index -> loose file
    replaced = []
    for r in lay["replaced_ranks"]:
        path = loose_path(int(rank_of[r]))
        old = tree[path]
        replaced.append((path, old, content(gen, device, len(old), spec,
                                            vocab)))
    removed = [(loose_path(int(rank_of[r])), tree[loose_path(int(rank_of[r]))])
               for r in lay["removed_ranks"]]
    added = [(f"content/loose/new/n{k:03d}.dat",
              content(gen, device, int(n), spec, vocab))
             for k, n in enumerate(lay["added"])]
    return tree, Patch(spans, replaced, added, removed)


def apply(tree: dict, patch: Patch) -> dict:
    """Version B in memory: A's arrays where unchanged, copies where not."""
    out = dict(tree)
    for path, off, _, new in patch.spans:
        if out[path] is tree[path]:
            out[path] = tree[path].copy()
        out[path][off:off + len(new)] = new
    for path, _, new in patch.replaced:
        out[path] = new
    for path, _ in patch.removed:
        del out[path]
    for path, new in patch.added:
        out[path] = new
    return out


def tree_bytes(tree: dict) -> int:
    return int(sum(len(v) for v in tree.values()))


def write(tree: dict, root: str) -> None:
    """Write the tree under root, files 0o644 and folders 0o755."""
    for path, data in tree.items():
        full = os.path.join(root, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        data.tofile(full)
        os.chmod(full, 0o644)
    for dirpath, _, _ in os.walk(root):
        os.chmod(dirpath, 0o755)
    # flushed now, so that the page cache's write-back does not fall in
    # the window
    os.sync()


def write_patch(patch: Patch, root: str) -> None:
    """Turn version A on disk into version B, the paks edited in place."""
    for path, off, _, new in patch.spans:
        with open(os.path.join(root, path), "r+b") as f:
            f.seek(off)
            f.write(new.tobytes())
    for path, _, new in patch.replaced:
        new.tofile(os.path.join(root, path))
    for path, _ in patch.removed:
        os.remove(os.path.join(root, path))
        # a folder left empty goes too: version B's tree holds no such folder
        parent = os.path.dirname(os.path.join(root, path))
        while parent != root and not os.listdir(parent):
            os.rmdir(parent)
            parent = os.path.dirname(parent)
    for path, new in patch.added:
        full = os.path.join(root, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        new.tofile(full)
        os.chmod(full, 0o644)
    for dirpath, _, _ in os.walk(root):
        os.chmod(dirpath, 0o755)
    os.sync()
