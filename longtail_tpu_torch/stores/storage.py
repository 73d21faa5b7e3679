"""StorageAPI: filesystem abstraction (reference src/longtail.h:364-393).

Two implementations, mirroring the reference seam:

- ``FSStorage``: the real filesystem (lib/filestorage/longtail_filestorage.c)
- ``MemStorage``: complete in-memory filesystem used as the test fake
  (lib/memstorage/longtail_memstorage.c)

Paths use "/" separators.  Directory paths may carry a trailing "/" (the
reference convention for dir assets in FileInfos).
"""

from __future__ import annotations

import dataclasses
import errno
import os
import stat as stat_mod
import threading
from typing import Iterator, Protocol


class StorageError(OSError):
    pass


def _raise(err: int, path: str):
    raise StorageError(err, os.strerror(err), path)


class Storage(Protocol):
    def read(self, path: str, offset: int = 0, size: int | None = None) -> bytes: ...
    def write(self, path: str, data: bytes, offset: int = 0) -> None: ...
    def open_append(self, path: str) -> None: ...
    def get_size(self, path: str) -> int: ...
    def set_size(self, path: str, size: int) -> None: ...
    def exists(self, path: str) -> bool: ...
    def is_dir(self, path: str) -> bool: ...
    def create_dir(self, path: str) -> None: ...
    def remove_file(self, path: str) -> None: ...
    def remove_dir(self, path: str) -> None: ...
    def rename(self, src: str, dst: str) -> None: ...
    def list_dir(self, path: str) -> list[str]: ...
    def get_permissions(self, path: str) -> int: ...
    def set_permissions(self, path: str, permissions: int) -> None: ...
    def lock_file(self, path: str): ...
    def unlock_file(self, handle) -> None: ...
    def map_file(self, path: str) -> "MappedFile": ...


class MappedFile:
    """Zero-copy read-only view of a file — the Longtail_StorageAPI
    MapFile/UnmapFile analog (src/longtail.h:380-382; the reference chunks
    via mmap in DynamicChunking src/longtail.c:2130-2216 and fsblockstore
    reads blocks via mmap, lib/fsblockstore/longtail_fsblockstore.c:928).

    ``view`` is a memoryview over the file bytes; use as a context manager
    so the underlying mapping is released deterministically."""

    def __init__(self, view: memoryview, closer=None):
        self.view = view
        self._closer = closer

    def __enter__(self) -> "MappedFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Best-effort unmap.  If the caller still holds zero-copy exports
        (np.frombuffer slices), the OS mapping stays alive until they are
        garbage-collected — same lifetime rule as the reference's
        UnmapFile-after-use discipline, but safe against early close."""
        try:
            if isinstance(self.view, memoryview):
                self.view.release()
        except BufferError:
            pass
        if self._closer is not None:
            try:
                self._closer()
            except BufferError:
                pass
            self._closer = None


def map_or_read(storage, path: str) -> MappedFile:
    """map_file when the storage supports it, else a bytes-backed view."""
    mf = getattr(storage, "map_file", None)
    if mf is not None:
        return mf(path)
    return MappedFile(memoryview(storage.read(path)))


def ensure_parent_dirs(storage: Storage, path: str) -> None:
    parent = path.rsplit("/", 1)[0] if "/" in path else ""
    if not parent or storage.is_dir(parent):
        return
    ensure_parent_dirs(storage, parent)
    try:
        storage.create_dir(parent)
    except StorageError as e:
        if e.errno != errno.EEXIST:
            raise


class FSStorage:
    """Real filesystem rooted at an optional base directory."""

    def __init__(self, base: str = ""):
        self.base = base

    def _p(self, path: str) -> str:
        return os.path.join(self.base, path) if self.base else path

    def read(self, path: str, offset: int = 0, size: int | None = None) -> bytes:
        with open(self._p(path), "rb") as f:
            if offset:
                f.seek(offset)
            return f.read(size) if size is not None else f.read()

    def write(self, path: str, data: bytes, offset: int = 0) -> None:
        p = self._p(path)
        if offset:
            # a nonexistent target is created and zero-extended to the
            # offset (matching MemStorage and the reference filestorage's
            # OpenWriteFile(0)+Write-at-offset semantics) — "r+b" alone
            # would raise on a file the caller hasn't pre-created
            with open(p, "r+b" if os.path.exists(p) else "w+b") as f:
                f.seek(offset)
                f.write(data)
        else:
            with open(p, "wb") as f:
                f.write(data)

    def write_ranges(self, path: str, total_size: int,
                     ranges: list[tuple[int, bytes]]) -> None:
        """Random-access scatter writes (ConcurrentChunkWriteAPI analog,
        src/longtail.h:464-472): pre-size the file, write each
        (offset, data).  Consecutive ranges coalesce into one
        ``os.pwritev`` per run — block scatters arrive in file order, so
        a 4 GiB downsync would otherwise issue ~250k per-chunk buffered
        write+seek calls (measured: >5 s of pure Python I/O overhead,
        the reconstruct hot path's dominant cost)."""
        p = self._p(path)
        fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, total_size)
            pwritev = getattr(os, "pwritev", None)
            i, n = 0, len(ranges)
            while i < n:
                off = ranges[i][0]
                j = i
                end = off
                while j < n and ranges[j][0] == end:
                    end += len(ranges[j][1])
                    j += 1
                bufs = [r[1] for r in ranges[i:j]]
                if pwritev is not None:
                    for k in range(0, len(bufs), 1024):   # IOV_MAX
                        chunk = bufs[k:k + 1024]
                        written = pwritev(fd, chunk, off)
                        expect = sum(len(b) for b in chunk)
                        while written < expect:   # short write: finish
                            os.lseek(fd, off + written, os.SEEK_SET)
                            flat = b"".join(bytes(b) for b in chunk)
                            os.write(fd, flat[written:])
                            written = expect
                        off += expect
                else:
                    os.lseek(fd, off, os.SEEK_SET)
                    for b in bufs:
                        os.write(fd, b)
                i = j
        finally:
            os.close(fd)

    def map_file(self, path: str) -> MappedFile:
        """mmap the file read-only (src/longtail.c:2130-2216)."""
        import mmap as _mmap

        f = open(self._p(path), "rb")
        try:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                f.close()
                return MappedFile(memoryview(b""))
            m = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except Exception:
            f.close()
            raise

        def closer(m=m, f=f):
            m.close()
            f.close()

        return MappedFile(memoryview(m), closer)

    def get_size(self, path: str) -> int:
        return os.path.getsize(self._p(path))

    def set_size(self, path: str, size: int) -> None:
        with open(self._p(path), "r+b") as f:
            f.truncate(size)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._p(path))

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(self._p(path))

    def create_dir(self, path: str) -> None:
        try:
            os.mkdir(self._p(path))
        except FileExistsError:
            _raise(errno.EEXIST, path)

    def remove_file(self, path: str) -> None:
        os.unlink(self._p(path))

    def remove_dir(self, path: str) -> None:
        os.rmdir(self._p(path))

    def rename(self, src: str, dst: str) -> None:
        os.replace(self._p(src), self._p(dst))

    def list_dir(self, path: str) -> list[str]:
        return sorted(os.listdir(self._p(path)))

    def scan_dir(self, path: str) -> list[tuple[str, bool, int, int]]:
        """Single-pass (name, is_dir, size, permissions) listing: one
        scandir + one stat per entry instead of three stats.  Entries
        that cannot be stat'd (dangling symlinks, raced deletions —
        normal in real trees like /usr) are skipped, not fatal."""
        out = []
        with os.scandir(self._p(path)) as it:
            for e in it:
                try:
                    if e.is_symlink():
                        # never follow: a symlinked dir double-counts (or
                        # loops) the scan, and a reconstructed tree would
                        # materialize copies where links were
                        continue
                    st = e.stat()
                    is_dir = e.is_dir()
                except OSError:
                    # dangling/raced entries are normal in real trees
                    continue
                out.append((e.name, is_dir, 0 if is_dir else st.st_size,
                            stat_mod.S_IMODE(st.st_mode)))
        out.sort()
        return out

    def get_permissions(self, path: str) -> int:
        return stat_mod.S_IMODE(os.stat(self._p(path)).st_mode)

    def set_permissions(self, path: str, permissions: int) -> None:
        os.chmod(self._p(path), permissions)

    def lock_file(self, path: str):
        """Inter-process advisory lock (Longtail_LockFile,
        lib/longtail_platform.h:88-91)."""
        import fcntl
        fd = os.open(self._p(path), os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(fd, fcntl.LOCK_EX)
        return fd

    def unlock_file(self, handle) -> None:
        import fcntl
        fcntl.flock(handle, fcntl.LOCK_UN)
        os.close(handle)


@dataclasses.dataclass
class _MemEntry:
    data: bytearray | None  # None => directory
    permissions: int = 0o644


class MemStorage:
    """In-memory filesystem fake (lib/memstorage/longtail_memstorage.c).

    Thread-safe via one lock (the reference uses a spinlock per API)."""

    def __init__(self):
        self._entries: dict[str, _MemEntry] = {}
        self._lock = threading.RLock()
        self._file_locks: dict[str, threading.Lock] = {}

    @staticmethod
    def _norm(path: str) -> str:
        return path.strip("/")

    def read(self, path: str, offset: int = 0, size: int | None = None) -> bytes:
        with self._lock:
            e = self._entries.get(self._norm(path))
            if e is None or e.data is None:
                _raise(errno.ENOENT, path)
            end = len(e.data) if size is None else offset + size
            return bytes(e.data[offset:end])

    def write(self, path: str, data: bytes, offset: int = 0) -> None:
        with self._lock:
            key = self._norm(path)
            e = self._entries.get(key)
            if e is None:
                e = _MemEntry(data=bytearray())
                self._entries[key] = e
            if e.data is None:
                _raise(errno.EISDIR, path)
            if offset == 0:
                # whole-file replace, matching FSStorage's "wb" truncate
                # (positional writes that must preserve existing bytes go
                # through offset > 0 or write_ranges)
                e.data = bytearray(data)
                return
            if offset + len(data) > len(e.data):
                e.data.extend(b"\0" * (offset + len(data) - len(e.data)))
            e.data[offset:offset + len(data)] = data

    def write_ranges(self, path: str, total_size: int,
                     ranges: list[tuple[int, bytes]]) -> None:
        with self._lock:
            key = self._norm(path)
            e = self._entries.get(key)
            if e is None:
                e = _MemEntry(data=bytearray(total_size))
                self._entries[key] = e
            if e.data is None:
                _raise(errno.EISDIR, path)
            if len(e.data) != total_size:
                e.data = bytearray(e.data[:total_size]) + \
                    bytearray(total_size - min(total_size, len(e.data)))
            for off, data in ranges:
                e.data[off:off + len(data)] = data

    def map_file(self, path: str) -> MappedFile:
        """Zero-copy view of the in-memory entry.  A mutation through
        write() while the map is open may invalidate the view (same
        contract as an mmap'd file changing under the reader)."""
        with self._lock:
            e = self._entries.get(self._norm(path))
            if e is None or e.data is None:
                _raise(errno.ENOENT, path)
            return MappedFile(memoryview(e.data).toreadonly())

    def get_size(self, path: str) -> int:
        with self._lock:
            e = self._entries.get(self._norm(path))
            if e is None or e.data is None:
                _raise(errno.ENOENT, path)
            return len(e.data)

    def set_size(self, path: str, size: int) -> None:
        with self._lock:
            e = self._entries.get(self._norm(path))
            if e is None or e.data is None:
                _raise(errno.ENOENT, path)
            del e.data[size:]
            if len(e.data) < size:
                e.data.extend(b"\0" * (size - len(e.data)))

    def exists(self, path: str) -> bool:
        with self._lock:
            return self._norm(path) in self._entries

    def is_dir(self, path: str) -> bool:
        with self._lock:
            key = self._norm(path)
            if key == "":
                return True
            e = self._entries.get(key)
            return e is not None and e.data is None

    def create_dir(self, path: str) -> None:
        with self._lock:
            key = self._norm(path)
            if key in self._entries:
                if self._entries[key].data is None:
                    _raise(errno.EEXIST, path)
                _raise(errno.ENOTDIR, path)
            self._entries[key] = _MemEntry(data=None, permissions=0o755)

    def remove_file(self, path: str) -> None:
        with self._lock:
            key = self._norm(path)
            e = self._entries.get(key)
            if e is None or e.data is None:
                _raise(errno.ENOENT, path)
            del self._entries[key]

    def remove_dir(self, path: str) -> None:
        with self._lock:
            key = self._norm(path)
            e = self._entries.get(key)
            if e is None or e.data is not None:
                _raise(errno.ENOENT, path)
            prefix = key + "/"
            if any(k.startswith(prefix) for k in self._entries):
                _raise(errno.ENOTEMPTY, path)
            del self._entries[key]

    def rename(self, src: str, dst: str) -> None:
        # POSIX-faithful (this class is the primary test fake — its
        # fidelity is the e2e suite's ceiling): renaming a directory
        # moves its children; a file may replace an existing file but
        # not a directory; a directory may only replace an empty one
        with self._lock:
            skey, dkey = self._norm(src), self._norm(dst)
            e = self._entries.get(skey)
            if e is None:
                _raise(errno.ENOENT, src)
            d = self._entries.get(dkey)
            is_dir = e.data is None
            if d is not None and skey != dkey:
                if is_dir:
                    if d.data is not None:
                        _raise(errno.ENOTDIR, dst)
                    if any(k.startswith(dkey + "/") for k in self._entries):
                        _raise(errno.ENOTEMPTY, dst)
                    del self._entries[dkey]
                elif d.data is None:
                    _raise(errno.EISDIR, dst)
            self._entries[dkey] = self._entries.pop(skey)
            if is_dir:
                prefix = skey + "/"
                moved = [k for k in self._entries if k.startswith(prefix)]
                for k in moved:
                    self._entries[dkey + "/" + k[len(prefix):]] = \
                        self._entries.pop(k)

    def list_dir(self, path: str) -> list[str]:
        with self._lock:
            key = self._norm(path)
            prefix = key + "/" if key else ""
            if key and not self.is_dir(path):
                _raise(errno.ENOENT, path)
            names = set()
            for k in self._entries:
                if k.startswith(prefix) and k != key:
                    rest = k[len(prefix):]
                    names.add(rest.split("/", 1)[0])
            return sorted(names)

    def get_permissions(self, path: str) -> int:
        with self._lock:
            e = self._entries.get(self._norm(path))
            if e is None:
                _raise(errno.ENOENT, path)
            return e.permissions

    def set_permissions(self, path: str, permissions: int) -> None:
        with self._lock:
            e = self._entries.get(self._norm(path))
            if e is None:
                _raise(errno.ENOENT, path)
            e.permissions = permissions

    def lock_file(self, path: str):
        with self._lock:
            lock = self._file_locks.setdefault(self._norm(path), threading.Lock())
        lock.acquire()
        return lock

    def unlock_file(self, handle) -> None:
        handle.release()


def _scan_dir(storage: Storage, full: str):
    """One directory's entries as (name, is_dir, size, permissions).

    Storages may override with a single-pass implementation (FSStorage uses
    os.scandir); this fallback works over any Storage protocol object.
    """
    scan = getattr(storage, "scan_dir", None)
    if scan is not None:
        return scan(full)
    out = []
    for name in storage.list_dir(full):
        child = f"{full}/{name}"
        if storage.is_dir(child):
            out.append((name, True, 0, storage.get_permissions(child)))
        else:
            out.append((name, False, storage.get_size(child),
                        storage.get_permissions(child)))
    return out


def walk_files(storage: Storage, root: str,
               path_filter=None) -> Iterator[tuple[str, int, int]]:
    """Yield (relative_path, size, permissions); dirs end with '/', size 0.

    Deterministic (sorted) traversal; the reference scans with parallel jobs
    and leaves order unspecified (Longtail_GetFilesRecursively2,
    src/longtail.c:1656), so sorted order is a superset guarantee.
    """
    def recurse(rel: str):
        full = f"{root}/{rel}" if rel else root
        for name, is_dir, size, perm in _scan_dir(storage, full):
            child_rel = f"{rel}/{name}" if rel else name
            if is_dir:
                dir_path = child_rel + "/"
                if path_filter is None or path_filter(dir_path):
                    yield (dir_path, 0, perm)
                    yield from recurse(child_rel)
            else:
                if path_filter is None or path_filter(child_rel):
                    yield (child_rel, size, perm)
    yield from recurse("")


def walk_files_parallel(storage: Storage, root: str, path_filter=None,
                        workers: int = 8) -> list[tuple[str, int, int]]:
    """Parallel folder scan: one job per directory, like the reference's
    ScanFolder job fan-out (Longtail_GetFilesRecursively2,
    src/longtail.c:1656-1790).  Returns the same entries as ``walk_files``
    in the same deterministic order (sorted by path components, dirs before
    their children).
    """
    import concurrent.futures as cf

    entries: list[tuple[str, int, int]] = []
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        pending = {ex.submit(_scan_dir, storage, root): ""}
        while pending:
            done, _ = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
            for fut in done:
                rel = pending.pop(fut)
                for name, is_dir, size, perm in fut.result():
                    child_rel = f"{rel}/{name}" if rel else name
                    if is_dir:
                        dir_path = child_rel + "/"
                        if path_filter is None or path_filter(dir_path):
                            entries.append((dir_path, 0, perm))
                            full = f"{root}/{child_rel}"
                            pending[ex.submit(_scan_dir, storage, full)] = \
                                child_rel
                    elif path_filter is None or path_filter(child_rel):
                        entries.append((child_rel, size, perm))
    entries.sort(key=lambda e: e[0].split("/"))
    return entries
