"""In-memory storage plugin: a flat key → bytes store.

Used by tests and as a model of an object store. ``memory://bucket/prefix``
URLs resolve to one shared dict per bucket within a process. Every op
runs on the event loop's thread and never awaits, so it needs no lock.
"""

from typing import Dict, Optional

from ..io_types import IOReq, StoragePlugin


class MemoryStoragePlugin(StoragePlugin):
    def __init__(
        self, store: Optional[Dict[str, bytes]] = None, prefix: str = ""
    ) -> None:
        self.store: Dict[str, bytes] = store if store is not None else {}
        self.prefix = f"{prefix.rstrip('/')}/" if prefix else ""

    def _key(self, path: str) -> str:
        return self.prefix + path

    async def write(self, io_req: IOReq) -> None:
        payload = io_req.data if io_req.data is not None else io_req.buf.getbuffer()
        self.store[self._key(io_req.path)] = bytes(payload)

    async def read(self, io_req: IOReq) -> None:
        try:
            io_req.data = self.store[self._key(io_req.path)]
        except KeyError:
            # The same not-found dialect as the fs plugin.
            raise FileNotFoundError(io_req.path) from None

    def close(self) -> None:
        pass
