"""FaultPlugin: a StoragePlugin wrapper that injects scheduled faults.

Composable over any backend (memory, fs, cloud) and installed UNDER the
retry layer by :func:`inject`, so injected transient errors exercise the
real retry policy while a :class:`~.schedule.SimulatedCrash`
(``BaseException``) rips through it the way process death would.

Layering when active::

    RetryingStoragePlugin( FaultPlugin( FSStoragePlugin | Memory... ) )

``inject`` also registers the controller as a storage-op hook
(:func:`torchsnapshot_tpu_torch.io_types.add_storage_op_hook`), so backend
sub-step boundaries (fs.py's write → fsync → rename → dir-fsync) count
as op boundaries and can crash too.
"""

import logging
from contextlib import contextmanager
from typing import Iterator, Optional

from ..io_types import (
    IOReq,
    StoragePlugin,
    add_storage_op_hook,
    io_payload,
    remove_storage_op_hook,
)
from .schedule import FaultController, FaultSchedule, TornWrite


class FaultPlugin(StoragePlugin):
    """Wrap ``inner``, consulting ``controller`` before every op."""

    def __init__(self, inner: StoragePlugin, controller: FaultController) -> None:
        self._inner = inner
        self._controller = controller
        self.max_write_concurrency = inner.max_write_concurrency
        self.max_read_concurrency = inner.max_read_concurrency

    async def write(self, io_req: IOReq) -> None:
        torn = self._controller.on_op("write", io_req.path)
        if torn is not None:
            await self._write_torn(io_req, torn)
            return
        await self._inner.write(io_req)

    async def _write_torn(self, io_req: IOReq, torn: TornWrite) -> None:
        # The partial payload LANDS (that is the point: the backend now
        # holds a torn object), then the scheduled failure strikes. On
        # the fs backend the inner write is still atomic tmp+rename, so
        # this models a torn OBJECT (truncated payload, complete
        # visibility protocol); to tear the protocol itself, crash
        # between fs.write.* sub-steps instead.
        payload = io_payload(io_req)
        keep = max(0, min(torn.keep_bytes, len(payload)))
        await self._inner.write(
            IOReq(path=io_req.path, data=bytes(payload[:keep]))
        )
        self._controller.torn_followup(torn, "write", io_req.path)

    async def read(self, io_req: IOReq) -> None:
        self._controller.on_op("read", io_req.path)
        await self._inner.read(io_req)

    async def delete(self, path: str) -> None:
        self._controller.on_op("delete", path)
        await self._inner.delete(path)

    async def list_prefix(self, prefix: str):
        self._controller.on_op("list", prefix)
        return await self._inner.list_prefix(prefix)

    async def object_age_s(self, path: str) -> Optional[float]:
        self._controller.on_op("age", path)
        return await self._inner.object_age_s(path)

    async def object_size_bytes(self, path: str) -> Optional[int]:
        self._controller.on_op("size", path)
        return await self._inner.object_size_bytes(path)

    def ensure_durable(self) -> None:
        self._controller.on_op("durable", "")
        self._inner.ensure_durable()

    def close(self) -> None:
        # A dead process never closes cleanly: after a crash, close() is
        # a silent no-op — the inner plugin must NOT get a chance to
        # settle deferred durability work (fs dirent fsyncs) the real
        # crashed process would have lost. Raising here instead would
        # shadow the original SimulatedCrash inside ``finally:`` blocks.
        if self._controller.crashed:
            return
        # close IS an op boundary: a crash scheduled here dies before
        # the inner close settles deferred fsyncs (the latch above then
        # suppresses the inner call on every later close).
        self._controller.on_op("close", "")
        self._inner.close()


@contextmanager
def inject(
    schedule: Optional[FaultSchedule] = None,
    controller: Optional[FaultController] = None,
) -> Iterator[FaultController]:
    """Install fault injection process-wide for the duration of the block.

    Every storage plugin resolved while active (take, marker finalize,
    prune, reconcile each resolve their own) is wrapped in a
    :class:`FaultPlugin` sharing ONE controller — op indices form a
    single global stream — and backend sub-step hooks route to the same
    controller. With an empty schedule this is a pure op counter: the
    crash-point enumerator's dry run.

    Not reentrant, and the caller must not leak pipelines past the block
    (an async_take still draining when the block exits would keep faulting
    through the captured wrapper on its already-open plugin, but new
    plugin resolutions go back to the real backends).
    """
    from .. import storage_plugin as _sp

    ctl = controller if controller is not None else FaultController(schedule)
    prev = None

    def _wrap(plugin: StoragePlugin, url: str) -> StoragePlugin:
        # Chain over any previously installed wrap hook instead of
        # shadowing it: faults then strike the composed stack.
        base = plugin if prev is None else prev(plugin, url)
        return FaultPlugin(base, ctl)

    prev = _sp.set_plugin_wrap_hook(_wrap)
    add_storage_op_hook(ctl.on_subop)
    try:
        yield ctl
    finally:
        remove_storage_op_hook(ctl.on_subop)
        _sp.set_plugin_wrap_hook(prev)
        # A wire fault a drop_conn/torn_frame/slow_wire rule armed but no
        # RPC consumed (the matched host was substituted out before its
        # next dial) must not leak into an unrelated later RPC.
        try:
            from ..hottier import transport as _wire_transport

            _wire_transport.clear_wire_faults()
        except Exception:
            logging.getLogger(__name__).warning(
                "faultline: wire-fault cleanup failed", exc_info=True
            )
