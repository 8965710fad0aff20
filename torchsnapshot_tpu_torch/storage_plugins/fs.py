"""Local-filesystem storage plugin.

Blocking file IO runs in the event loop's default executor, so a large
write releases the GIL in one ``file.write`` call. Each object is written
to a temporary name, fsynced and renamed into place; the renamed
directory entries of data objects are made durable in one batch before
the next publish point (a dot-prefixed name such as the snapshot
metadata), so the metadata can never reference a file a crash could lose.
Each write announces its sub-steps (``fs.write.tmp``, ``.fsync``,
``.rename``, ``.dirsync``) to ``io_types``' storage-op hooks, where
fault injection can crash between them, and a publish point first
removes the torn temporaries a dead writer left for the same name.
"""

import asyncio
import errno
import os
import threading
import time
from typing import List, Optional, Set

from .. import telemetry
from ..io_types import IOReq, StoragePlugin, emit_storage_op, io_payload


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

    @staticmethod
    def _writer_alive(pid_str: str) -> bool:
        """Whether the process that named a ``.tmp<pid>`` file still runs
        on this host. EPERM means alive (another user's process); an
        unparseable suffix reads as alive: fail toward keeping."""
        if not (pid_str.isascii() and pid_str.isdigit()):
            return True
        try:
            os.kill(int(pid_str), 0)
        except ProcessLookupError:
            return False
        # EPERM (someone else's live process), OverflowError (a numeric
        # suffix past C long — not a real pid), and friends: keep.
        except Exception:  # snapcheck: disable=swallowed-exception -- fails toward keeping
            return True
        return True

    @classmethod
    def _clean_stale_tmp(cls, full: str, own_tmp: str) -> None:
        """Remove the torn ``<name>.tmp<pid>`` siblings a crashed process
        left for the object about to be (re)written. Only a dead writer's:
        a live concurrent writer's tmp (a reconcile adopting the marker an
        async finalize is writing now) must survive, or its rename fails.
        Only publish points pay this: they are small directories, and the
        paths re-driven after a crash; payload debris in step directories
        is reclaimed by sweeps."""
        d = os.path.dirname(full)
        prefix = os.path.basename(full) + ".tmp"
        own = os.path.basename(own_tmp)
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return
        for name in names:
            if (
                name.startswith(prefix)
                and name != own
                and not cls._writer_alive(name[len(prefix):])
            ):
                try:
                    os.remove(os.path.join(d, name))
                except FileNotFoundError:
                    pass  # a concurrent cleanup removed it first

    def _write_sync(self, io_req: IOReq) -> None:
        self._prepare_dir(io_req.path)
        full = os.path.join(self.root, io_req.path)
        publish = self._is_publish_point(io_req.path)
        if publish:
            # Every dirent the metadata may reference must be durable
            # BEFORE the publishing rename can reach disk.
            self._flush_dirty_dirs()
        tmp = f"{full}.tmp{os.getpid()}"
        if publish:
            self._clean_stale_tmp(full, tmp)
        payload = io_req.data if io_req.data is not None else io_req.buf.getbuffer()
        # Sub-step boundaries (faultline): a hook may raise here to model
        # a crash between the steps of the durability protocol — after
        # the tmp data landed but before its fsync, after the fsync but
        # before the rename, after the rename but before the dirent is
        # durable.
        emit_storage_op("fs.write.tmp", io_req.path)
        with open(tmp, "wb") as f:
            f.write(payload)
            emit_storage_op("fs.write.fsync", io_req.path)
            # Data must be durable BEFORE the rename publishes the name.
            f.flush()
            os.fsync(f.fileno())
        emit_storage_op("fs.write.rename", io_req.path)
        os.replace(tmp, full)
        emit_storage_op("fs.write.dirsync", io_req.path)
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
        nbytes = len(io_payload(io_req))
        t0 = time.monotonic()
        await loop.run_in_executor(None, self._write_sync, io_req)
        telemetry.record_storage_op("fs", "write", time.monotonic() - t0, nbytes)

    async def read(self, io_req: IOReq) -> None:
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        await loop.run_in_executor(None, self._read_sync, io_req)
        telemetry.record_storage_op(
            "fs", "read", time.monotonic() - t0, len(io_payload(io_req))
        )

    async def delete(self, path: str) -> None:
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        await loop.run_in_executor(None, os.remove, os.path.join(self.root, path))
        telemetry.record_storage_op("fs", "delete", time.monotonic() - t0)

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

    async def object_size_bytes(self, path: str) -> Optional[int]:
        try:
            return os.stat(os.path.join(self.root, path)).st_size
        except FileNotFoundError:
            return None

    def close(self) -> None:
        # A plugin retired without reaching a publish point (an aborted
        # take) still leaves every dirent it created durable.
        self._flush_dirty_dirs()
