"""Coordination shim: small object collectives for the snapshot protocol.

The protocol needs only *tiny* object collectives — key lists and
manifests — plus barriers; bulk tensor data goes process→storage, never
process→process.

- ``Coordinator`` — the collective interface ``Snapshot`` uses.
- ``NoOpCoordinator`` — single process; every collective is the identity.
- ``Store`` with ``DictStore`` (threads of one process) and ``FileStore``
  (a directory on a shared filesystem): the blocking key-value stores the
  multi-rank coordinator will run over.

Multi-rank snapshots are not ported yet: ``get_coordinator`` resolves to
``NoOpCoordinator`` unless ``torch.distributed`` is initialised with a
world larger than one, which it refuses.
"""

import abc
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

_DEFAULT_TIMEOUT_S = 300.0


class Store(abc.ABC):
    """A blocking KV store: set once, get blocks until the key exists."""

    @abc.abstractmethod
    def set(self, key: str, value: bytes) -> None:
        ...

    @abc.abstractmethod
    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        ...

    def delete(self, key: str) -> None:
        """Best-effort removal of a key; deleting an absent key is a
        no-op."""


class DictStore(Store):
    """In-process store shared between threads simulating ranks."""

    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._data[key] = value
            self._cond.notify_all()

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"Timed out waiting for key: {key}")
                self._cond.wait(timeout=remaining)
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)


class FileStore(Store):
    """Directory-backed store for multi-process coordination on one node
    (or any shared filesystem). Writes are atomic via rename."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key.replace("/", "__"))

    def set(self, key: str, value: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.path)
        with os.fdopen(fd, "wb") as f:
            f.write(value)
        # No fsync: coordination keys are ephemeral per-collective values;
        # close() precedes the rename, so readers always see full data.
        os.replace(tmp, self._file(key))

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        target = self._file(key)
        deadline = time.monotonic() + timeout_s
        delay = 0.001
        while True:
            try:
                with open(target, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"Timed out waiting for key: {key}")
                time.sleep(delay)
                delay = min(delay * 2, 0.05)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._file(key))
        except FileNotFoundError:
            pass


class Coordinator(abc.ABC):
    """Collective interface used by Snapshot."""

    @abc.abstractmethod
    def get_rank(self) -> int:
        ...

    @abc.abstractmethod
    def get_world_size(self) -> int:
        ...

    @abc.abstractmethod
    def barrier(self, timeout_s: Optional[float] = None) -> None:
        ...

    @abc.abstractmethod
    def all_gather_object(self, obj: Any) -> List[Any]:
        ...

    @abc.abstractmethod
    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        ...


class NoOpCoordinator(Coordinator):
    def get_rank(self) -> int:
        return 0

    def get_world_size(self) -> int:
        return 1

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        pass

    def all_gather_object(self, obj: Any) -> List[Any]:
        return [obj]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        return obj


def get_coordinator(coord: Optional[Coordinator] = None) -> Coordinator:
    """Resolve the coordinator: explicit > single process.

    A ``torch.distributed`` job of more than one rank is refused rather
    than silently treated as world size 1, which would let every rank
    write a "complete" snapshot of only its own state.
    """
    if coord is not None:
        return coord
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "Multi-rank snapshots are not yet ported to "
            "torchsnapshot_tpu_torch (they come with slice S5); take and "
            "restore from a single process."
        )
    return NoOpCoordinator()
