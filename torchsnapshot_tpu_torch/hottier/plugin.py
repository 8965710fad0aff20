"""TieredPlugin: the hot tier as a composable StoragePlugin decorator.

Installed by :func:`~.runtime.enable_hot_tier` through the same
``set_plugin_wrap_hook`` seam faultline uses (hooks chain, so the two
compose in either order); ``url_to_storage_plugin`` then wraps the
result in the retry layer as usual::

    RetryingStoragePlugin( [FaultPlugin(] TieredPlugin( backend ) [)] )

Routing:

- **payload objects** (``<rank>/…``, ``replicated/…``, ``chunked/…``)
  write into peer-host RAM, k-replicated, and ACK without touching the
  durable tier; the runtime's drainer persists them in the background
  and records the ``.tierdown`` watermark (runtime.py). A put that
  cannot reach k replicas (dead or full peers, spare hosts included)
  writes through to the durable tier synchronously before the ack.
  Reads prefer a fingerprint-verified hot replica and fall back
  per-object to the durable tier, counting the degradation.
- **control plane** (anything dot-prefixed — metadata, completion
  markers, step markers, reports, progress, the ledger, ``.tierdown``
  itself — plus ``refs/`` back-links and ``@base…`` references) writes
  through synchronously: these ARE the commit protocol, and the
  metadata-last durability ordering they implement is exactly what the
  tier must not perturb. The metadata write doubles as the runtime's
  commit signal for the root.

``ensure_durable`` passes through untouched: under the hot tier it
makes the *control plane* durable, while payload durability is the
tier-down contract (ack-at-k-replicas, ``.tierdown`` when storage holds
everything) — the documented relaxation this subsystem exists for.

``list_prefix`` deliberately enumerates the DURABLE tier only: sweeps
and reconcile reason about storage objects; hot-only buffers are
reconciled through :func:`~.runtime.reconcile_hot_tier`'s own
accounting, never by pretending RAM is storage.
"""

import asyncio
import time
from typing import Optional

from ..io_types import IOReq, StoragePlugin, io_payload, is_not_found_error
from .runtime import (
    HotTierRuntime,
    _METADATA_FNAME,
    is_payload_path,
)


class TieredPlugin(StoragePlugin):
    def __init__(
        self, inner: StoragePlugin, runtime: HotTierRuntime, root: str
    ) -> None:
        self._inner = inner
        self._runtime = runtime
        self._root = root.rstrip("/")
        self.max_write_concurrency = inner.max_write_concurrency
        self.max_read_concurrency = inner.max_read_concurrency

    async def write(self, io_req: IOReq) -> None:
        rt = self._runtime
        if not rt.active or not is_payload_path(io_req.path):
            await self._inner.write(io_req)
            if rt.active and io_req.path == _METADATA_FNAME:
                # The commit point just landed: from here the take is
                # visible, and once its pending objects drain the
                # .tierdown watermark follows.
                rt.on_commit(self._root)
            return
        payload = bytes(io_payload(io_req))
        # hot_put runs INLINE on the event loop, wire RPCs included —
        # deliberately: serializing the hottier.replicate boundaries is
        # what keeps faultline's crash-point op stream deterministic
        # (concurrent executor-thread puts would interleave op indices
        # across replays), and the span inherits the take's ambient
        # trace. The cost is bounded by the per-RPC deadline + retry
        # budget per peer, after which the down-cooldown makes every
        # later push to that peer fail fast.
        placed, tag = rt.hot_put(self._root, io_req.path, payload)
        # The ack moment: hot_put returned — from here the object's
        # durability-lag clock runs (ack → drained, per object), fed to
        # the runtime alongside the payload size so the sampler's
        # at-risk accounting needs no tier re-probe.
        ack_t = time.monotonic()
        if placed < rt.k:
            # The ack-at-k contract cannot be met from RAM (dead or
            # full peers, spare hosts included): degrade to a
            # synchronous durable write BEFORE acknowledging — slower,
            # never less durable. Whatever replicas did land still
            # serve hot reads and are immediately evictable. The drain
            # pipeline for this path is quiesced FIRST, so a drain of
            # superseded bytes cannot land after our durable write; a
            # FAILED write re-arms the drain for the placed replicas so
            # the obligation is never silently retired. The quiesce can
            # block on an in-flight drain's durable write — run it off
            # the event loop so concurrent scheduler IO keeps flowing.
            await asyncio.get_running_loop().run_in_executor(
                None, rt.begin_write_through, self._root, io_req.path
            )
            try:
                await self._inner.write(io_req)
            except BaseException:
                rt.abort_write_through(
                    self._root, io_req.path, tag, placed
                )
                raise
            rt.note_write_through(
                self._root, io_req.path, tag, placed, nbytes=len(payload)
            )
            return
        rt.note_replicated_ack(len(payload))
        rt.enqueue_drain(
            self._root,
            io_req.path,
            tag,
            nbytes=len(payload),
            ack_t=ack_t,
        )

    async def read(self, io_req: IOReq) -> None:
        rt = self._runtime
        if rt.active and is_payload_path(io_req.path):
            data, attempted = rt.hot_get(
                self._root, io_req.path, io_req.byte_range
            )
            if data is not None:
                io_req.data = data
                return
            await self._inner.read(io_req)
            if attempted:
                # The hot tier knew this object and every replica was
                # dead/missing/corrupt: a counted degraded fallback —
                # and direct evidence of under-replication, so nudge
                # the snapmend repair plane instead of waiting out its
                # full interval.
                rt.note_fallback_bytes(len(io_payload(io_req)))
                rt.request_repair_scan()
            return
        await self._inner.read(io_req)

    async def delete(self, path: str) -> None:
        rt = self._runtime
        dropped = False
        if rt.active and is_payload_path(path):
            # Drop replicas AND cancel the pending drain first: a drain
            # racing this delete must not resurrect the object into the
            # durable tier after we removed it. forget_object can block
            # waiting out an in-flight drain — keep it off the event
            # loop so gathered deletes keep flowing.
            dropped = await asyncio.get_running_loop().run_in_executor(
                None, rt.forget_object, self._root, path
            )
        try:
            await self._inner.delete(path)
        except Exception as e:
            if dropped and is_not_found_error(e):
                return  # the object lived only in the hot tier
            raise

    async def list_prefix(self, prefix: str):
        return await self._inner.list_prefix(prefix)

    async def object_age_s(self, path: str) -> Optional[float]:
        try:
            age = await self._inner.object_age_s(path)
        except Exception as e:
            if not is_not_found_error(e):
                raise
            age = None
        if age is None and self._runtime.active and is_payload_path(path):
            return self._runtime.object_age_s(self._root, path)
        return age

    async def object_size_bytes(self, path: str) -> Optional[int]:
        try:
            size = await self._inner.object_size_bytes(path)
        except Exception as e:
            if not is_not_found_error(e):
                raise
            size = None
        if size is None and self._runtime.active and is_payload_path(path):
            return self._runtime.object_size_bytes(self._root, path)
        return size

    def ensure_durable(self) -> None:
        self._inner.ensure_durable()

    def close(self) -> None:
        # The drainer holds its own (bypassed) plugins; closing this one
        # never blocks on tier-down — preemption tolerance means the
        # foreground is free the moment the replicas are placed.
        self._inner.close()
