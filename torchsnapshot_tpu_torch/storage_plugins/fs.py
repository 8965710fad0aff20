"""Local-filesystem storage plugin.

Blocking file IO runs in the event loop's default executor, so a large
write releases the GIL in one ``file.write`` call. Each object is written
to a temporary name, fsynced and renamed into place; the renamed
directory entries of data objects are made durable in one batch before
the next publish point (a dot-prefixed name such as the snapshot
metadata), so the metadata can never reference a file a crash could lose.
"""

import asyncio
import errno
import os
import threading
import time
from typing import List, Optional, Set

from ..io_types import IOReq, StoragePlugin


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError as e:
        # Some filesystems (FUSE, 9p, network mounts) reject fsync on a
        # directory fd; degrade to rename-only semantics there rather
        # than failing a write whose data is already durable.
        if e.errno not in (errno.EINVAL, errno.ENOTSUP):
            raise
    finally:
        os.close(fd)


class FSStoragePlugin(StoragePlugin):
    # Local disks lose throughput to writeback contention under parallel
    # write streams; two keeps the device busy across file boundaries.
    max_write_concurrency = 2

    def __init__(self, root: str) -> None:
        self.root = root
        self._dir_cache: Set[str] = set()
        # Directories holding renamed-in data objects whose dirents have
        # not been fsynced yet (paid once, at the next publish point).
        self._dirty_dirs: Set[str] = set()
        self._lock = threading.Lock()

    def _prepare_dir(self, path: str) -> None:
        dir_path = os.path.dirname(os.path.join(self.root, path))
        with self._lock:
            if not dir_path or dir_path in self._dir_cache:
                return
        # Record which ancestors are about to be created: their dirents
        # must be durable too, or a crash could drop a directory whose
        # files the committed metadata references.
        created = []
        d = dir_path
        while d and not os.path.isdir(d):
            created.append(d)
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
        os.makedirs(dir_path, exist_ok=True)
        for d in reversed(created):
            _fsync_dir(os.path.dirname(d))
        with self._lock:
            self._dir_cache.update(created)
            self._dir_cache.add(dir_path)

    @staticmethod
    def _is_publish_point(path: str) -> bool:
        """A write that makes previously written objects *referenced*:
        snapshot metadata and markers, kept under dot-prefixed names."""
        first = path.split("/", 1)[0]
        return first.startswith(".") or os.path.basename(path).startswith(".")

    def _flush_dirty_dirs(self) -> None:
        with self._lock:
            dirty, self._dirty_dirs = self._dirty_dirs, set()
        for d in sorted(dirty):
            _fsync_dir(d)

    def ensure_durable(self) -> None:
        self._flush_dirty_dirs()

    def _write_sync(self, io_req: IOReq) -> None:
        self._prepare_dir(io_req.path)
        full = os.path.join(self.root, io_req.path)
        publish = self._is_publish_point(io_req.path)
        if publish:
            # Every dirent the metadata may reference must be durable
            # BEFORE the publishing rename can reach disk.
            self._flush_dirty_dirs()
        tmp = f"{full}.tmp{os.getpid()}"
        payload = io_req.data if io_req.data is not None else io_req.buf.getbuffer()
        with open(tmp, "wb") as f:
            f.write(payload)
            # Data must be durable BEFORE the rename publishes the name.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, full)
        if publish:
            _fsync_dir(os.path.dirname(full))
        else:
            with self._lock:
                self._dirty_dirs.add(os.path.dirname(full))

    def _read_sync(self, io_req: IOReq) -> None:
        with open(os.path.join(self.root, io_req.path), "rb") as f:
            if io_req.byte_range is None:
                io_req.data = f.read()
            else:
                start, end = io_req.byte_range
                f.seek(start)
                io_req.data = f.read(end - start)

    async def write(self, io_req: IOReq) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._write_sync, io_req)

    async def read(self, io_req: IOReq) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._read_sync, io_req)

    async def delete(self, path: str) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, os.remove, os.path.join(self.root, path))

    def _list_sync(self, prefix: str) -> List[str]:
        # Object-store semantics: a plain string prefix over paths relative
        # to the root. The walk never leaves the root (a sweep must not see
        # sibling snapshots) and starts at the deepest directory the prefix
        # names, so listing ".steps/" costs O(markers), not O(objects).
        found: List[str] = []
        walk_dir = self.root
        if "/" in prefix:
            walk_dir = os.path.join(self.root, prefix.rsplit("/", 1)[0])
        if not os.path.isdir(walk_dir):
            return found
        for dirpath, _, filenames in os.walk(walk_dir):
            for name in filenames:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                if rel.startswith(prefix):
                    found.append(rel)
        return found

    async def list_prefix(self, prefix: str) -> Optional[List[str]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._list_sync, prefix)

    async def object_age_s(self, path: str) -> Optional[float]:
        try:
            st = os.stat(os.path.join(self.root, path))
        except FileNotFoundError:
            return None  # vanished: deleting it is a no-op
        return max(0.0, time.time() - st.st_mtime)

    def close(self) -> None:
        # A plugin retired without reaching a publish point (an aborted
        # take) still leaves every dirent it created durable.
        self._flush_dirty_dirs()
