"""In-memory storage plugin: a flat key → bytes store.

Used by tests and as a model of an object store. ``memory://bucket/prefix``
URLs resolve to one shared dict per bucket within a process, so listing
``memory://run`` sees the objects of ``memory://run/step-1``, as on a
filesystem. Write times are kept beside each bucket for the sweeps' age
guard. Every op runs on the event loop's thread and never awaits, so it
needs no lock. A ranged read is served as a read-only ``memoryview`` of
the stored object, not a copy; a whole read hands out the stored object
itself.
"""

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..io_types import IOReq, StoragePlugin
from ..telemetry import metrics as _metric_names

# Write times per bucket, keyed by the bucket's id with the bucket itself
# held beside them (so the id is not reused), for the last 64 buckets:
# a sweep opens a new plugin on the same bucket and must see the same
# times. An evicted bucket's objects have no known age and are swept
# unconditionally, as on a backend that cannot report age.
_MTIMES_MAX_BUCKETS = 64
_MTIMES: "OrderedDict[int, Tuple[dict, Dict[str, float]]]" = OrderedDict()


def _mtimes_for(store: dict) -> Dict[str, float]:
    entry = _MTIMES.get(id(store))
    if entry is None or entry[0] is not store:
        entry = _MTIMES[id(store)] = (store, {})
    _MTIMES.move_to_end(id(store))
    while len(_MTIMES) > _MTIMES_MAX_BUCKETS:
        _MTIMES.popitem(last=False)
    return entry[1]


class MemoryStoragePlugin(StoragePlugin):
    def __init__(
        self, store: Optional[Dict[str, bytes]] = None, prefix: str = ""
    ) -> None:
        self.store: Dict[str, bytes] = store if store is not None else {}
        self.prefix = f"{prefix.rstrip('/')}/" if prefix else ""
        self._mtimes = _mtimes_for(self.store)

    def _key(self, path: str) -> str:
        return self.prefix + path

    async def write(self, io_req: IOReq) -> None:
        t0 = time.monotonic()
        payload = io_req.data if io_req.data is not None else io_req.buf.getbuffer()
        self.store[self._key(io_req.path)] = bytes(payload)
        self._mtimes[self._key(io_req.path)] = time.time()
        telemetry.record_storage_op("memory", "write", time.monotonic() - t0, len(payload))

    async def read(self, io_req: IOReq) -> None:
        t0 = time.monotonic()
        try:
            data = self.store[self._key(io_req.path)]
        except KeyError:
            # The same not-found dialect as the fs plugin.
            raise FileNotFoundError(io_req.path) from None
        if io_req.byte_range is not None:
            start, end = io_req.byte_range
            # The stored bytes are immutable: a view is the same bytes,
            # keeps the object alive, and costs no copy under the GIL on
            # the loop.
            data = memoryview(data)[start:end]
            telemetry.counter(_metric_names.STORAGE_READ_VIEW_BYTES, backend="memory").inc(len(data))
        io_req.data = data
        telemetry.record_storage_op("memory", "read", time.monotonic() - t0, len(data))

    async def delete(self, path: str) -> None:
        t0 = time.monotonic()
        key = self._key(path)
        if key not in self.store:
            raise FileNotFoundError(path)
        del self.store[key]
        self._mtimes.pop(key, None)
        telemetry.record_storage_op("memory", "delete", time.monotonic() - t0)

    async def list_prefix(self, prefix: str) -> Optional[List[str]]:
        full = self._key(prefix)
        return [k[len(self.prefix):] for k in self.store if k.startswith(full)]

    async def object_age_s(self, path: str) -> Optional[float]:
        mtime = self._mtimes.get(self._key(path))
        return None if mtime is None else max(0.0, time.time() - mtime)

    async def object_size_bytes(self, path: str) -> Optional[int]:
        data = self.store.get(self._key(path))
        return None if data is None else len(data)

    def close(self) -> None:
        pass
