"""The general job driver: a traffic file says what one job is, and this
module sets it up and runs it through ``longtail_tpu_torch.api``.

Traffic keys: ``job`` is ``upsync`` or ``downsync``; an upsync's
``store`` is ``empty`` (a fresh store every job) or ``previous`` (a
store that holds version A, restored between jobs, while the job
upsyncs version B); ``source`` is ``disk`` (the tree under the run's
scratch folder, read through FSStorage) or ``memory`` (a MemStorage);
``patch`` gives the edits that make version B.  A downsync job changes a
client folder that holds one version into the other, alternating.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from longtail_tpu_torch import api
from longtail_tpu_torch.stores.compressblockstore import CompressBlockStore
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
from longtail_tpu_torch.stores.storage import (
    FSStorage,
    MemStorage,
    ensure_parent_dirs,
)

from ltbench import tree as tree_mod

# the store's folder inside its storage, and the client's
STORE = "store"
TARGET = "target"


def read_all(storage, root: str, data: bool = True) -> tuple[dict, set]:
    """(path -> bytes of every file, set of folders) under root; with
    data=False the files map to None."""
    files, dirs = {}, set()
    if not storage.is_dir(root):
        return files, dirs
    stack = [""]
    while stack:
        rel = stack.pop()
        full = f"{root}/{rel}" if rel else root
        for name in storage.list_dir(full):
            child = f"{rel}/{name}" if rel else name
            if storage.is_dir(f"{root}/{child}"):
                dirs.add(child)
                stack.append(child)
            else:
                files[child] = storage.read(f"{root}/{child}") if data \
                    else None
    return files, dirs


def _to_memory(tree: dict, root: str) -> MemStorage:
    mem = MemStorage()
    for path, data in tree.items():
        full = f"{root}/{path}"
        ensure_parent_dirs(mem, full)
        mem.write(full, data.tobytes())
    return mem


def _patch_memory(mem: MemStorage, patch, root: str) -> None:
    for path, off, _, new in patch.spans:
        mem.write(f"{root}/{path}", new.tobytes(), off)
    for path, _, new in patch.replaced:
        mem.write(f"{root}/{path}", new.tobytes())
    for path, _ in patch.removed:
        mem.remove_file(f"{root}/{path}")
        parent = f"{root}/{path}".rsplit("/", 1)[0]
        while parent != root and not mem.list_dir(parent):
            mem.remove_dir(parent)
            parent = parent.rsplit("/", 1)[0]
    for path, new in patch.added:
        ensure_parent_dirs(mem, f"{root}/{path}")
        mem.write(f"{root}/{path}", new.tobytes())


class Jobs:
    """One cell's set-up and jobs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 scratch: str, record=None, spec: dict | None = None):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.scratch = scratch
        self.record = record
        spec = dict(spec or cfg["tree"])
        if "patch" in traffic:
            spec["patch"] = traffic["patch"]
        self.a, self.patch = tree_mod.make(spec, seed, self.device)
        self.b = tree_mod.apply(self.a, self.patch) if "patch" in traffic \
            else None
        self.outputs = []          # per job: what the reference judges
        self.digests = set()

    # -- the program's calls ---------------------------------------------

    def store(self, storage):
        st = CompressBlockStore(FSBlockStore(storage, STORE),
                                device=self.device)
        if self.record is not None:
            self.record.wrap_store(st)
        return st

    def upsync(self, src, root: str, storage):
        c = self.cfg
        vi, _ = api.upsync(
            src, root, self.store(storage),
            target_chunk_size=c["target_chunk_size"],
            target_block_size=c["target_block_size"],
            max_chunks_per_block=c["max_chunks_per_block"],
            min_block_usage_percent=c["min_block_usage_percent"],
            hash_identifier=c["hash_identifier"],
            compression_tag=c["compression_tag"],
            workers=c["workers"], device=self.device)
        return vi

    def downsync(self, storage, target, vi) -> None:
        api.downsync(self.store(storage), target, TARGET, vi,
                     min_block_usage_percent=self.cfg[
                         "min_block_usage_percent"],
                     workers=self.cfg["workers"], device=self.device)

    # -- set-up ------------------------------------------------------------

    def _source(self, tree: dict, name: str):
        if self.traffic["source"] == "disk":
            root = os.path.join(self.scratch, name)
            tree_mod.write(tree, root)
            return FSStorage(), root
        return _to_memory(tree, name), name

    def setup(self) -> None:
        t = self.traffic
        self.src, self.root = self._source(self.a, "a")
        if t["job"] == "upsync" and t["store"] == "previous":
            self.base = MemStorage()
            self.upsync(self.src, self.root, self.base)
            self.base_files = set(read_all(self.base, STORE, False)[0])
            self.base_lsi = self.base.read(f"{STORE}/store.lsi")
            self._to_b()
        elif t["job"] == "downsync":
            self.base = MemStorage()
            self.vis = [self.upsync(self.src, self.root, self.base)]
            self._to_b()
            self.vis.append(self.upsync(self.src, self.root, self.base))
            self.target = MemStorage()
            self.downsync(self.base, self.target, self.vis[0])

    def _to_b(self) -> None:
        if self.traffic["source"] == "disk":
            tree_mod.write_patch(self.patch, self.root)
        else:
            _patch_memory(self.src, self.patch, self.root)

    # -- the window ----------------------------------------------------------

    def source_bytes(self, k: int) -> int:
        """Bytes of the tree that job k upsyncs, or that it downsyncs."""
        t = self.traffic
        if t["job"] == "upsync":
            return tree_mod.tree_bytes(self.a if t["store"] == "empty"
                                       else self.b)
        return tree_mod.tree_bytes(self.b if k % 2 == 0 else self.a)

    def before(self, k: int) -> None:
        """The harness's own work between jobs, outside their time."""
        t = self.traffic
        if t["job"] == "upsync" and t["store"] == "previous" and k > 0:
            files, _ = read_all(self.base, STORE, False)
            for path in set(files) - self.base_files:
                self.base.remove_file(f"{STORE}/{path}")
            self.base.write(f"{STORE}/store.lsi", self.base_lsi)

    def job(self, k: int):
        t = self.traffic
        if t["job"] == "upsync":
            storage = MemStorage() if t["store"] == "empty" else self.base
            vi = self.upsync(self.src, self.root, storage)
            return vi, storage
        self.downsync(self.base, self.target, self.vis[(k + 1) % 2])
        return None, self.target

    def keep(self, k: int, out) -> None:
        """What job k's reference check needs, taken after the job (the
        harness's work, outside the window's rate): the .lvi of an
        upsync and the files of its store (of a patch upsync's store,
        the blocks it added and store.lsi), the blocks only where no
        earlier job's were the same; after a downsync, the digest of
        every file of the client folder."""
        vi, storage = out
        if vi is None:
            self.outputs.append((k, None, file_digests(storage, TARGET),
                                 None))
            return
        listed = read_all(storage, STORE, False)[0]
        if self.traffic["store"] == "previous":
            listed = [p for p in listed
                      if p not in self.base_files or p == "store.lsi"]
        files = {f"{STORE}/{p}": storage.read(f"{STORE}/{p}")
                 for p in listed}
        key = blocks_digest(files)
        if key in self.digests:
            files = {p: b for p, b in files.items()
                     if not p.endswith(".lrb")}
        self.digests.add(key)
        self.outputs.append((k, vi.to_bytes(), files, key))

    def results(self):
        """(job, .lvi or None, store files or (digests, folders) of the
        client folder, expected tree, digest of the store's blocks) per
        job, once the window has closed.  A patch upsync's blocks are
        judged with the blocks of version N that its store held."""
        t = self.traffic
        base = {}
        if t["job"] == "upsync" and t["store"] == "previous":
            base = {f"{STORE}/{p}": self.base.read(f"{STORE}/{p}")
                    for p in self.base_files if p != "store.lsi"}
        out = []
        for k, lvi, held, key in self.outputs:
            if lvi is not None:
                want = self.a if t["store"] == "empty" else self.b
                if base and any(p.endswith(".lrb") for p in held):
                    held = {**base, **held}
            else:
                want = self.b if k % 2 == 0 else self.a
            out.append((k, lvi, held, want, key))
        return out

    def final(self):
        """The client folder after the last job."""
        return read_all(self.target, TARGET)

    def release(self) -> None:
        """Drop the program's state (stores, sources, folders)."""
        for name in ("src", "base", "target", "vis", "outputs"):
            if hasattr(self, name):
                setattr(self, name, None)


def blocks_digest(files: dict) -> bytes:
    """sha256 over a store's block files (not store.lsi, whose order of
    blocks follows the writer threads)."""
    digest = hashlib.sha256()
    for path in sorted(files):
        if path.endswith(".lrb"):
            digest.update(path.encode() + b"\0" + files[path])
    return digest.digest()



def file_digests(storage, root: str) -> tuple[dict, set]:
    """(path -> sha1 of the file's bytes, set of folders) under root,
    the files hashed on threads (hashlib lets go of the GIL)."""
    files, dirs = read_all(storage, root, False)

    def one(path):
        return path, hashlib.sha1(storage.read(f"{root}/{path}")).digest()

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, sorted(files))), dirs
