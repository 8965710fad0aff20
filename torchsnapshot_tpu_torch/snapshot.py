"""Snapshot: take/restore of an app state of tensors, in the JAX package's
on-disk format.

``take``:
  1. capture and save the RNG stateful *first*; re-load its captured state
     after all other statefuls were saved, so their ``state_dict()`` side
     effects do not leak into the program;
  2. save the other statefuls in sorted key order: flatten each state
     dict into logical paths, stage every tensor's bytes into a private
     host buffer (a pinned one, through a D2H on a side stream, for CUDA
     tensors) and write them under a host-memory budget;
  3. write the metadata document last — the commit point: a snapshot
     without metadata is invisible.

Every rank of a ``torch.distributed`` job takes part (the coordinator,
``coord.py``): the ranks agree on the app-state keys and, per stateful,
on the ``replicated=`` paths (the intersection of every rank's glob
matches), each replicated value is written once, by an owner chosen to
balance the bytes, and a sharded DTensor's boxes are written once each.
Rank 0 commits the merged manifest of every rank. Values are per-rank,
replicated or sharded, so a state saved by N ranks restores on M: a
replicated or sharded value restores on any rank, a per-rank value only
on the rank that saved it.

``restore`` reads the metadata, loads the statefuls in sorted key order
and the RNG stateful last. An array restores onto the device of its
template tensor, a DTensor template takes its local box. When the
template's device, dtype, shape and layout match the stored array (the
box), the bytes go **into the template tensor in place**, so the
restored state dict holds the template tensors themselves. Each leaf is
published whole: a leaf of one verified whole-object read that reaches
the template in one transfer (on a card, at most one 16 MiB staging
slot) lands in the template directly, any other leaf in a private buffer
on the template's device that is copied into the template once all of
its bytes have verified and landed (``io_preparer.py``). A failed restore raises and
leaves every leaf it did not finish with its old values. The reads run
through the scheduler's host and device budgets and the H2D pipeline
(pinned pooled staging buffers); the consume profile of the last
restore is kept in ``_last_restore_report``.

``async_take`` captures the same cut before it returns and drains it on
a background thread. Tensors are mutable, so the cut must be complete in
stream order before the caller may touch them again: ``stage="device"``
clones CUDA tensors on the card, on the current stream (the caller's next
in-place update is queued after the clones), and copies host tensors on
the host; ``stage="host"`` stages every payload to host memory first;
``stage="auto"`` clones and falls back to host staging, with a warning,
when the clones do not fit on the card. The drain stages the clones to
pinned host memory on side streams that wait on an event recorded after
them, writes the payloads, and commits through the JAX package's storage
markers: a ``.completed/<take_id>/<rank>`` document carrying the rank's
manifest, then the metadata with the same ``take_id``. A snapshot taken
asynchronously by either package restores through the other.

``read_object`` fetches one value (or one subtree) without a restore.
``delete`` removes a snapshot, metadata first, and with ``sweep=True``
the objects its manifest does not reference.

Deduplication, as the JAX package writes and reads it:

- ``compression="zlib"`` compresses every stored payload;
- ``base=`` (a committed snapshot or its path) makes an incremental
  take (``incremental.py``): a leaf whose fingerprint (K4 on the card)
  equals the base's is not copied or written, and its entry borrows the
  base's object; ``fingerprint=`` records fingerprints so that this
  snapshot can serve as a later base (on by default with a base, or with
  ``TPUSNAPSHOT_FINGERPRINT=1``);
- ``chunks=True`` (or ``TPUSNAPSHOT_CHUNKS=1``) writes array payloads as
  content chunks into the run's ``.chunkstore`` (``chunkstore.py``; K5 on
  the card), each only if the store lacks it, through the ``codec=``
  (``codecs.py``; ``TPUSNAPSHOT_CODEC``);
- ``restore(verify_device=True)`` recomputes every restored leaf's
  fingerprint where the manifest has one (K4 on the card) and raises on a
  mismatch;
- ``delete`` refuses while a live incremental snapshot borrows from this
  one, and frees the chunks no other live snapshot lists.

A base path is compared with the take's path after normalisation (the
``fs`` scheme, ``os.path.normpath``, ``realpath`` for a filesystem path):
a take can never use itself as its base, however the two are spelled.
The rest of the API, as the JAX package has it:

- ``restore(paths=[globs])`` restores only the leaves whose
  ``"<stateful_key>/<flattened/path>"`` matches a glob (the others keep
  their values, and only the selected leaves' objects are read); a
  filter that matches nothing raises;
- ``verify()`` scrubs every stored object against its checksum and size
  (large objects streamed through a running crc32, content chunks
  decoded and fingerprinted), touching no device, and returns
  ``{location: problem}``;
- ``copy_to(dest)`` copies the snapshot to another location or backend,
  checking every payload in transit, materialising borrowed objects and
  content chunks so the copy stands alone, metadata last;
- ``diff(older)`` says which paths were added, removed, changed,
  unchanged or unknown, from the two metadata documents alone;
- a sync take whose manifest is larger than
  ``TPUSNAPSHOT_COMMIT_VIA_STORAGE_BYTES`` (1 MiB) on some rank commits
  through storage markers, as an async take does, instead of gathering
  every manifest through the coordinator;
- every rank takes rank 0's ``path`` (a rank that passed another logs a
  warning).

JAX PRNG-key leaves restore as their raw uint32 key data.
"""

import asyncio
import fnmatch
import json
import logging
import os
import pickle
import posixpath
import threading
import time
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from .coord import Coordinator, barrier_compat, get_coordinator, get_rank
from .flatten import flatten, inflate
from .io_preparer import (
    ArrayRestorePlan,
    device_clone_write_reqs,
    get_device_restore_budget_bytes,
    prepare_read,
    prepare_write,
)
from .io_types import (
    BufferStager,
    IOReq,
    ReadReq,
    StoragePlugin,
    WriteReq,
    io_payload,
    is_not_found_error,
    is_range_not_satisfiable_error,
)
from .manifest import (
    ArrayEntry,
    DictEntry,
    Entry,
    ListEntry,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
    entry_has_content,
    get_available_entries,
    is_replicated,
)
from .rng_state import RNGState
from .serialization import check_compression
from .scheduler import (
    _MAX_STAGING_THREADS,
    execute_read_reqs,
    execute_write_reqs,
    get_memory_budget_bytes,
)
from .stateful import AppState, Stateful
from .storage_plugin import (
    RefRouterPlugin,
    is_ref_location,
    make_ref_location,
    parse_ref_location,
    resolve_base_ref,
    url_to_storage_plugin,
)
from . import telemetry, tracing
from .telemetry import consume_profile as _cprof
from .telemetry import goodput as goodput_acct
from .telemetry import ledger as runledger
from .telemetry import metrics as _metric_names
from .telemetry import progress as liveprog
from .telemetry import report as flight
from .utils.env import env_int

logger = logging.getLogger(__name__)

# The format version this package writes: the JAX package's, whose
# format it shares.
FORMAT_VERSION = "0.4.0"

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"

# verify() reads an object larger than this in ranged reads of this size
# through a running crc32, so its memory is this times the read fan-out.
_VERIFY_SCRUB_CHUNK_BYTES = 64 * 1024 * 1024

# A sync take commits through storage markers, not a gather of every
# manifest through the coordinator, once some rank's pickled manifest is
# larger than this (rank 0's value holds for every rank).
_COMMIT_VIA_STORAGE_ENV_VAR = "TPUSNAPSHOT_COMMIT_VIA_STORAGE_BYTES"
_DEFAULT_COMMIT_VIA_STORAGE_BYTES = 1 << 20

# The last take's deduplication numbers on this rank (:func:`_prepare_take`):
# fingerprinted leaves, leaf hits, chunk hits and misses, stored bytes.
_last_take_stats: Optional[Dict[str, Any]] = None

# The last restore's (or read_object's) consume profile and read-pipeline
# numbers (:func:`_set_restore_report`), kept for a caller to read
# (chip_smoke.py prints it); a restore's flight report carries the same
# profile.
_last_restore_report: Optional[Dict[str, Any]] = None

# The last ``restore(verify_device=True)``'s counts on this rank
# (:func:`_verify_restored_fingerprints`): leaves or shard boxes whose
# fingerprint was recomputed and matched, and those skipped.
_last_verify_stats: Optional[Dict[str, int]] = None


class Snapshot:
    """A handle to a snapshot location; cheap until used."""

    def __init__(self, path: str, coord: Optional[Coordinator] = None) -> None:
        self.path = path
        self._coord = coord
        self._metadata: Optional[SnapshotMetadata] = None
        # get_available_entries of the cached metadata, by rank.
        self._available_cache: Dict[int, Manifest] = {}

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        coord: Optional[Coordinator] = None,
        replicated: Optional[List[str]] = None,
        compression: Optional[str] = None,
        base: Optional[Any] = None,
        fingerprint: Optional[bool] = None,
        chunks: Optional[bool] = None,
        codec: Optional[Any] = None,
    ) -> "Snapshot":
        """Persist ``app_state`` to ``path``; returns a handle. Returns
        once every payload is written and the metadata committed, so the
        caller may change its tensors afterwards. A collective: every
        rank calls it with the same ``path``.

        ``replicated`` is a list of globs over logical paths
        (``"model/**"``, ``"**"``) whose values are the same on every
        rank: each is written once and restores on any rank, at any
        world size. A path counts as replicated only where every rank
        matched it. Sharded DTensors are written by their own rule
        whatever the globs say.

        ``compression`` ("zlib" or None) compresses every stored payload.
        ``base`` (a committed :class:`Snapshot` or its path) makes the
        take incremental; ``fingerprint`` records content fingerprints
        (default: on with a base or ``TPUSNAPSHOT_FINGERPRINT=1``);
        ``chunks`` writes through the run's content-chunk store and
        ``codec`` picks its codecs (a name, a ``{glob: codec}`` mapping,
        or ``TPUSNAPSHOT_CODEC``). Rank 0's ``base``, ``fingerprint``,
        ``chunks`` and ``codec`` hold for every rank. The handle returned
        serves as the next take's base without reading its metadata.

        The manifests reach rank 0 through the coordinator, or, once some
        rank's is larger than ``TPUSNAPSHOT_COMMIT_VIA_STORAGE_BYTES``
        (default 1 MiB), through storage markers as in an async take:
        one object a rank instead of every manifest to every rank."""
        coordinator = get_coordinator(coord)
        path = _collate_path(coordinator, path)
        # The whole sync take blocks the caller's loop (checkpoint time
        # for goodput); every span below carries the take's trace id.
        with goodput_acct.blocked("sync_take"), tracing.trace_scope("take"), tracing.span(
            "Snapshot.take", path=path
        ):
            metadata = cls._take_sync(
                path, app_state, coordinator, replicated, compression, base, fingerprint,
                chunks, codec,
            )
        snapshot = cls(path, coord)
        if metadata is not None:
            snapshot._metadata = _decorate_metadata_refs(metadata)
        return snapshot

    @classmethod
    def _take_sync(
        cls,
        path: str,
        app_state: AppState,
        coordinator: Coordinator,
        replicated: Optional[List[str]],
        compression: Optional[str],
        base: Optional[Any],
        fingerprint: Optional[bool],
        chunks: Optional[bool],
        codec: Optional[Any],
    ) -> Optional[SnapshotMetadata]:
        rank = coordinator.get_rank()
        world_size = coordinator.get_world_size()
        recorder, watch = _take_telemetry("take", path, rank, world_size)
        manifest, write_reqs, base_paths, chunk_ctx, churn = _prepare_take(
            path, app_state, coordinator, replicated, compression, base, fingerprint, chunks,
            codec, recorder, watch,
        )
        budget = get_memory_budget_bytes(coordinator)
        storage = url_to_storage_plugin(path)
        metadata: Optional[SnapshotMetadata] = None
        try:
            writer = chunk_ctx.wrap(storage) if chunk_ctx is not None else storage
            write_stats: Dict[str, Any] = {}
            watch.set_phase("write")
            with recorder.phase("write"):
                asyncio.run(
                    execute_write_reqs(
                        write_reqs, writer, budget, rank, stats=write_stats, progress=watch
                    )
                )
            recorder.note_pipeline(write_stats)
            if chunk_ctx is not None:
                # Stored sizes exist only after the writes.
                chunk_ctx.stats.fold_into_churn(churn)
                recorder.note(churn=churn)
            # Every object this rank wrote is durable before its manifest
            # reaches rank 0, which may commit at once.
            writer.ensure_durable()
            watch.set_phase("commit")
            # The route must be the same on every rank, so both of its
            # inputs are gathered (rank 0's threshold holds); rank 0's
            # take_id rides the same gather.
            gathered = coordinator.all_gather_object(
                (
                    len(pickle.dumps(manifest, protocol=4)),
                    _commit_via_storage_threshold(),
                    uuid.uuid4().hex if rank == 0 else None,
                )
            )
            threshold, take_id = gathered[0][1], gathered[0][2]
            if world_size > 1 and max(size for size, _, _ in gathered) > threshold:
                # Rank 0 collects every marker (so every rank's writes are
                # done), writes the chunk refs and then the metadata; the
                # rank summaries ride storage beside the markers.
                with recorder.phase("commit"):
                    metadata = asyncio.run(
                        _acommit_via_storage(
                            storage, rank, world_size, manifest, take_id,
                            base_paths=base_paths, snapshot_path=path,
                            rank_summary=recorder.rank_summary(), kind="take",
                        )
                    )
            else:
                with recorder.phase("commit"):
                    metadata = SnapshotMetadata(
                        version=FORMAT_VERSION,
                        world_size=world_size,
                        manifest=_merge_manifests(coordinator.all_gather_object(manifest)),
                        take_id=take_id,
                        base_paths=list(base_paths),
                    )
                    if rank == 0:
                        # The chunk-ref document before the commit point: a
                        # committed manifest is always protected from chunk GC.
                        _write_chunk_refs(path, metadata)
                        asyncio.run(_write_metadata(storage, metadata))
                # The rank summaries ride the coordinator on this route;
                # every rank issues the gather.
                summaries = coordinator.all_gather_object(recorder.rank_summary())
                if rank == 0:
                    report = flight.build_report("take", path, take_id, world_size, summaries)
                    _write_report_best_effort(storage, report)
                    _ledger_append_best_effort(path, report)
            # No rank returns before rank 0's metadata write.
            barrier_compat(coordinator, _COMPLETION_TIMEOUT_S)
            watch.finish()
            flight.local_export(recorder)
        finally:
            storage.close()
            if chunk_ctx is not None:
                chunk_ctx.cleanup()
        return metadata

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        coord: Optional[Coordinator] = None,
        replicated: Optional[List[str]] = None,
        *,
        compression: Optional[str] = None,
        stage: str = "auto",
        base: Optional[Any] = None,
        fingerprint: Optional[bool] = None,
        chunks: Optional[bool] = None,
        codec: Optional[Any] = None,
    ) -> "PendingSnapshot":
        """Capture a consistent cut of ``app_state`` and return; the
        payload writes and the metadata commit drain on a background
        thread. Call ``.wait()`` (or check ``.done()``) before depending
        on the snapshot.

        ``stage`` chooses how the cut is captured:

        - ``"device"`` — clone CUDA tensors on the card (the stall is one
          on-card copy, which needs room for the clones there) and copy
          host tensors on the host; raise if the clones do not fit;
        - ``"host"`` — stage every payload to host memory before
          returning (the stall is one full device→host copy);
        - ``"auto"`` — as ``"device"``, falling back to ``"host"`` with a
          warning when the clones do not fit.

        The caller may mutate its tensors in place as soon as this
        returns: work it queues on the current stream runs after the
        clones. ``replicated``, ``compression``, ``base``,
        ``fingerprint``, ``chunks`` and ``codec`` are as for :meth:`take`;
        fingerprints and chunk keys are computed before the cut is
        captured, so a deduplicated leaf is neither cloned nor copied.
        The positional order is the JAX package's up to ``replicated``;
        the options after it are keyword-only.
        """
        if stage not in ("auto", "host", "device"):
            raise ValueError(f'stage must be "auto", "host", or "device"; got {stage!r}')
        coordinator = get_coordinator(coord)
        path = _collate_path(coordinator, path)
        # Only the capture stalls the caller (goodput "async_stall"); the
        # drain adopts the take's trace id on its own thread.
        with goodput_acct.blocked("async_stall"), tracing.trace_scope("async_take"):
            background, storage = cls._async_capture(
                path, app_state, coordinator, replicated, compression, stage, base,
                fingerprint, chunks, codec,
            )
        return PendingSnapshot(path, coord, background, storage)

    @classmethod
    def _async_capture(
        cls,
        path: str,
        app_state: AppState,
        coordinator: Coordinator,
        replicated: Optional[List[str]],
        compression: Optional[str],
        stage: str,
        base: Optional[Any],
        fingerprint: Optional[bool],
        chunks: Optional[bool],
        codec: Optional[Any],
    ) -> Tuple["_BackgroundTake", StoragePlugin]:
        """The foreground of an async take: the cut, the take_id and the
        drain thread started. Returns the drain and the storage plugin
        that :class:`PendingSnapshot` closes."""
        rank = coordinator.get_rank()
        world_size = coordinator.get_world_size()
        recorder, watch = _take_telemetry("async_take", path, rank, world_size)
        manifest, write_reqs, base_paths, chunk_ctx, churn = _prepare_take(
            path, app_state, coordinator, replicated, compression, base, fingerprint, chunks,
            codec, recorder, watch,
        )
        budget = get_memory_budget_bytes(coordinator)
        background = _BackgroundTake()
        try:
            watch.set_phase("prestage")
            with recorder.phase("prestage"):
                _prestage_write_reqs(write_reqs, budget, stage, coordinator)
            # Per-take nonce: completion markers and metadata from earlier
            # or concurrent takes to the same path never satisfy this
            # take's polls; it becomes the committed metadata's take_id.
            background.take_id = coordinator.broadcast_object(
                uuid.uuid4().hex if rank == 0 else None, src=0
            )
        except BaseException:
            if chunk_ctx is not None:
                chunk_ctx.cleanup()
            raise
        storage = url_to_storage_plugin(path)
        writer = chunk_ctx.wrap(storage) if chunk_ctx is not None else storage
        # With the nonce, live progress can ride the snapshot's storage.
        watch.attach_storage(storage, background.take_id)
        # Captured here, inside the take's trace scope; the drain adopts it.
        take_trace_id = tracing.current_trace_id()

        async def _drain() -> None:
            background.phase = "storage writes"
            watch.set_phase("write")
            await watch.async_tick(force=True)
            write_stats: Dict[str, Any] = {}
            drain_t0 = time.monotonic()
            await execute_write_reqs(
                write_reqs, writer, budget, rank, stats=write_stats, progress=watch
            )
            recorder.add_phase("write", time.monotonic() - drain_t0)
            recorder.note_pipeline(write_stats)
            if chunk_ctx is not None:
                chunk_ctx.stats.fold_into_churn(churn)
                recorder.note(churn=churn)
            writer.ensure_durable()
            # The marker carries the manifest, so it is serialised only
            # now: staging fills in the payload checksums and chunk records.
            background.phase = "commit markers"
            watch.set_phase("commit")
            await watch.async_tick(force=True)
            commit_t0 = time.monotonic()
            await _acommit_via_storage(
                storage, rank, world_size, manifest, background.take_id,
                base_paths=base_paths, snapshot_path=path,
                rank_summary=recorder.rank_summary(), kind="async_take", progress=watch,
            )
            recorder.add_phase("commit", time.monotonic() - commit_t0)
            watch.finish()
            flight.local_export(recorder)

        def _run() -> None:
            try:
                with tracing.adopt_trace(take_trace_id):
                    asyncio.run(_drain())
            finally:
                if chunk_ctx is not None:
                    chunk_ctx.cleanup()

        try:
            background.start(_run)
        except BaseException:
            storage.close()
            if chunk_ctx is not None:
                chunk_ctx.cleanup()
            raise
        return background, storage

    def delete(self, sweep: bool = False, force: bool = False) -> None:
        """Delete this snapshot from storage, as the JAX package does.

        The metadata (the commit point) goes first, so an interrupted
        delete leaves an unreadable snapshot, never a readable one with
        missing payloads; then every payload its manifest references, its
        commit markers and the records kept beside a snapshot. Missing
        objects are skipped. Payloads borrowed from a base snapshot are
        the base's to delete; content chunks go through the chunk store's
        GC (``chunkstore.gc_snapshot_chunks``): this snapshot's ref
        document goes, and the chunks no other live snapshot lists are
        freed.

        If a live incremental snapshot still references this one (a
        back-link under ``refs/`` naming a committed snapshot whose
        entries borrow from here, or a young one naming a take still in
        flight; ``TPUSNAPSHOT_REFS_MIN_AGE_S``, default 3600), delete
        refuses with ``RuntimeError`` unless ``force=True``.

        ``sweep=True`` also removes objects under the prefix that the
        manifest does not reference (leftovers of interrupted takes); the
        metadata may then be missing or unreadable. Unreferenced objects
        younger than ``TPUSNAPSHOT_SWEEP_MIN_AGE_S`` (default 3600) are
        spared: they may belong to a take in flight at the same path.
        Single-process: run it from one rank.
        """
        min_age_s = _env_seconds("TPUSNAPSHOT_SWEEP_MIN_AGE_S")
        refs_min_age_s = _env_seconds("TPUSNAPSHOT_REFS_MIN_AGE_S")
        storage = url_to_storage_plugin(self.path)
        try:
            try:
                metadata: Optional[SnapshotMetadata] = _read_metadata_doc(storage)
            except Exception as e:
                if not sweep:
                    raise
                if not is_not_found_error(e):
                    logger.warning(
                        f"Snapshot metadata at {self.path} is unreadable "
                        f"({e!r}); sweeping without it."
                    )
                metadata = None
            if not force:
                refs = asyncio.run(
                    _live_referencers(storage, self.path, refs_min_age_s)
                )
                if refs:
                    raise RuntimeError(
                        f"Snapshot {self.path} is still referenced by "
                        f"incremental snapshot(s) {sorted(refs)}; deleting it "
                        f"would corrupt them. Delete those first, or pass "
                        f"force=True."
                    )
            # Hot-tier replicas of this snapshot go first, before any
            # durable delete: queued tier-down drains are cancelled and
            # in-flight ones waited out, so a background drain cannot
            # resurrect a deleted snapshot's objects into the durable
            # tier after the deletes below.
            try:
                from . import hottier as _hottier

                _hottier.forget_root(self.path)
            except Exception as e:
                logger.warning(f"hot-tier buffer GC failed: {e!r}")
            asyncio.run(_delete_snapshot(storage, metadata, sweep, min_age_s))
            self.invalidate_caches()
            if metadata is not None and metadata.base_paths:
                asyncio.run(_gc_backlinks_in_bases(metadata, self.path))
            if metadata is not None:
                from . import chunkstore

                # The metadata is gone: a crash from here on only leaks,
                # and reconcile re-drives the GC.
                try:
                    chunkstore.gc_snapshot_chunks(self.path, metadata)
                except Exception as e:
                    logger.warning(f"chunk-store GC failed: {e!r} (reconcile re-drives it)")
        finally:
            storage.close()

    def is_referenced(self) -> bool:
        """Whether a live incremental snapshot still references this one
        (see :meth:`delete`). Retention defers such a snapshot."""
        storage = url_to_storage_plugin(self.path)
        try:
            return bool(
                asyncio.run(
                    _live_referencers(
                        storage, self.path, _env_seconds("TPUSNAPSHOT_REFS_MIN_AGE_S")
                    )
                )
            )
        finally:
            storage.close()

    def restore(
        self,
        app_state: AppState,
        coord: Optional[Coordinator] = None,
        paths: Optional[List[str]] = None,
        verify_device: bool = False,
    ) -> None:
        """Restore ``app_state`` in place from this snapshot.

        ``paths`` restores only the leaves whose logical path matches one
        of its globs (``["model/**"]``: the weights without the optimizer
        state), in the namespace of ``replicated`` and :meth:`read_object`:
        ``"<stateful_key>/<flattened/path>"``. The other leaves keep their
        values (their tensors untouched), a stateful with no selected leaf
        is not loaded at all, and only the selected leaves' objects are
        read. A filter that selects nothing raises ``RuntimeError``, after
        every collective.

        ``verify_device=True`` recomputes every restored array's
        fingerprint where the manifest recorded one (K4 on the card, all
        dispatched before one batched fetch) and raises ``RuntimeError``
        if the restored bytes differ from what the take fingerprinted.
        Leaves without a fingerprint, and lossily coded ones, are
        skipped."""
        coordinator = get_coordinator(coord if coord is not None else self._coord)
        rank = coordinator.get_rank()
        storage = self._open_storage()
        try:
            with goodput_acct.blocked("restore"), tracing.trace_scope("restore"), tracing.span(
                "Snapshot.restore", path=self.path
            ):
                self._restore(app_state, coordinator, rank, storage, paths, verify_device)
        finally:
            storage.close()

    def _restore(
        self,
        app_state: AppState,
        coordinator: Coordinator,
        rank: int,
        storage: StoragePlugin,
        paths: Optional[List[str]],
        verify_device: bool,
    ) -> None:
        token = _cprof.begin()
        stats: Dict[str, Any] = {}
        verify_jobs: Optional[List[Tuple[str, Entry, Any]]] = [] if verify_device else None
        n_selected = 0
        try:
            metadata = self._read_metadata(storage)
            available = self._available_entries(metadata, rank)
            # The rank's flight record of this restore: the read, consume
            # and assemble breakdown, written best-effort at the end.
            recorder = flight.FlightRecorder(kind="restore", path=self.path, rank=rank)
            tracing.set_identity(rank=rank)
            watch = liveprog.ProgressPublisher(
                kind="restore", path=self.path, rank=rank,
                world_size=coordinator.get_world_size(),
            )
            watch.set_phase("restore")
            telemetry.counter(_metric_names.RESTORES_TOTAL).inc()
            # Hot-tier attribution: which objects peer RAM served and
            # which fell back to the durable tier, and which peers were
            # degraded — the flight report's ``tier`` block, read by the
            # hot-tier-degraded doctor rule and the ledger. None whenever
            # the tier is off.
            from . import hottier as _hottier

            tier_token = _hottier.restore_stats_begin()
            # Read-plane attribution: which objects the read service
            # served and which fell back to direct backend reads — the
            # flight report's ``read_plane`` block, read by the
            # read-plane-degraded doctor rule and the ledger. None
            # whenever the restore saw no snapserve traffic.
            from .snapserve import client as _snapserve_client

            read_plane_token = _snapserve_client.restore_stats_begin()
            app_state = dict(app_state)
            rng_key, rng_stateful = _pop_rng_state(app_state)
            # Every rank joins every per-key barrier, whichever statefuls
            # it holds, so the ranks stay in step.
            global_keys = _gather_keys(coordinator, sorted(app_state))
            budget = get_memory_budget_bytes(coordinator)
            worlds = (coordinator.get_world_size(), metadata.world_size)
            for key in global_keys:
                if key in app_state:
                    n_selected += _load_stateful(
                        key, app_state[key], available, storage, rank, budget, worlds, stats,
                        verify_jobs, paths, watch,
                    )
                coordinator.barrier()
            if rng_stateful is not None:
                n_selected += _load_stateful(
                    rng_key, rng_stateful, available, storage, rank, budget, worlds, stats,
                    verify_jobs, paths, watch,
                )
            watch.finish()
            tier_summary = _hottier.restore_stats_collect(tier_token)
            if tier_summary is not None:
                recorder.note(tier=tier_summary)
            read_plane_summary = _snapserve_client.restore_stats_collect(read_plane_token)
            if read_plane_summary is not None:
                recorder.note(read_plane=read_plane_summary)
        finally:
            assemble_s = stats.pop("assemble_s", 0.0)
            profile = _set_restore_report(token, stats)
        _finish_restore_report(
            recorder, stats, assemble_s, profile, storage, self.path, rank, coordinator
        )
        if verify_jobs is not None:
            verified, skipped = _verify_restored_fingerprints(verify_jobs)
            logger.info(
                f"restore(verify_device=True): {verified} leaf/leaves fingerprint-"
                f"verified, {skipped} skipped (no recorded fingerprint)."
            )
        if paths is not None and n_selected == 0:
            # Most likely a typo: a silent no-op would resume from fresh
            # weights. Every collective above has completed.
            raise RuntimeError(
                f"restore(paths={paths!r}) matched no leaf in the app_state. "
                f'Leaves are named "<stateful_key>/<flattened/path>", e.g. '
                f'"model/params/w"; see get_manifest().'
            )

    def read_object(
        self, logical_path: str, template: Any = None, rank: Optional[int] = None
    ) -> Any:
        """Fetch ONE persisted value without a full restore.

        ``logical_path`` is ``"<stateful_key>/<flattened/path>"``.
        ``template`` sets the target: a tensor's device (an array lands on
        the card for a CUDA template) or a numpy array; with None an
        array returns as a CPU tensor. A container path returns its whole
        subtree with host values."""
        if rank is None:
            rank = get_rank(self._coord)
        storage = self._open_storage()
        token = _cprof.begin()
        stats: Dict[str, Any] = {}
        try:
            available = self._available_entries(self._read_metadata(storage), rank)
            if logical_path not in available:
                known = [
                    p for p in sorted(available)
                    if not isinstance(available[p], (ListEntry, DictEntry))
                ]
                raise KeyError(
                    f'"{logical_path}" is not in the snapshot (for rank '
                    f"{rank}). Available leaves include: {', '.join(known[:10])}"
                )
            entry = available[logical_path]
            if not isinstance(entry, (ListEntry, DictEntry)):
                result: Dict[str, Any] = {}
                reqs, plans = prepare_read(entry, template, lambda v: result.update(v=v))
                _run_reads(reqs, plans, storage, rank, get_memory_budget_bytes(), stats)
                return result["v"]
            if template is not None:
                raise ValueError(
                    f'"{logical_path}" is a container; pass template=None '
                    f"(container reads return host values) or read leaves "
                    f"individually."
                )
            prefix = logical_path + "/"
            containers: Manifest = {}
            flattened: Dict[str, Any] = {}
            reqs: List[ReadReq] = []
            plans: List[ArrayRestorePlan] = []
            for p, e in available.items():
                if p != logical_path and not p.startswith(prefix):
                    continue
                if isinstance(e, (ListEntry, DictEntry)):
                    containers[p] = e
                    continue

                def _cb(value: Any, p: str = p) -> None:
                    flattened[p] = value

                r, f = prepare_read(e, None, _cb)
                reqs.extend(r)
                plans.extend(f)
            _run_reads(reqs, plans, storage, rank, get_memory_budget_bytes(), stats)
            return inflate(containers, flattened, prefix=logical_path)
        finally:
            storage.close()
            stats.pop("assemble_s", None)
            _set_restore_report(token, stats)

    def get_manifest(self) -> Manifest:
        """The merged manifest of all ranks (inspection API)."""
        storage = url_to_storage_plugin(self.path)
        try:
            return dict(self._read_metadata(storage).manifest)
        finally:
            storage.close()

    def diff(self, other: Any, rank: int = 0) -> Dict[str, List[str]]:
        """What changed from ``other`` (the older snapshot, a handle or a
        path) to this one, by logical path as ``rank`` sees them:
        ``added``, ``removed``, ``changed``, ``unchanged``, and
        ``unknown`` where neither fingerprints nor comparable checksums
        decide. Reads the two metadata documents and no payload; takes
        with ``fingerprint=True`` make it exact leaf by leaf, and region
        by region for sharded values. Single-process, collective-free."""
        older = other if isinstance(other, Snapshot) else Snapshot(str(other))
        mine = get_available_entries(self.get_manifest(), rank)
        theirs = get_available_entries(older.get_manifest(), rank)

        def _is_container(e: Entry) -> bool:
            return isinstance(e, (ListEntry, DictEntry))

        out: Dict[str, List[str]] = {
            "added": [], "removed": [], "changed": [], "unchanged": [], "unknown": [],
        }
        for path in sorted(set(mine) | set(theirs)):
            a, b = theirs.get(path), mine.get(path)
            if a is not None and _is_container(a) and b is not None and _is_container(b):
                continue  # structure shows through its leaves
            if b is None or (a is not None and _is_container(b)):
                out["removed"].append(path)
            elif a is None or _is_container(a):
                out["added"].append(path)
            else:
                out[_diff_verdict(a, b)].append(path)
        return out

    def copy_to(self, dest_path: str, verify: bool = True) -> "Snapshot":
        """Copy this committed snapshot to ``dest_path``, on any backend.

        Every payload object is copied with bounded concurrency and, in
        bytes, under ``TPUSNAPSHOT_COPY_BUDGET_BYTES`` (2 GiB; an object
        larger than the budget copies alone; an object entry, whose size
        the manifest does not record, is sized by the source backend).
        ``verify=True`` checks each payload against its checksum in
        transit, so a corrupt source object raises instead of spreading.
        Objects borrowed from a base snapshot and content-chunked values
        are materialised (chunks decoded and verified) at their own
        locations, so the copy stands alone and restores through the
        plain path. The metadata is written last: an interrupted copy
        leaves no readable snapshot. Single-process, like :meth:`delete`.
        Returns the destination's handle."""
        src = self._open_storage()
        dst = url_to_storage_plugin(dest_path)
        try:
            metadata = self._read_metadata(src)
            by_loc: Dict[str, Any] = {}
            # Chunked entries, keyed by their natural location (a leaf
            # whose chunks are shared still gets its own payload).
            chunked_by_natural: Dict[str, Any] = {}
            materialized_checksums: Dict[str, str] = {}
            for entry in _iter_payload_entries(metadata.manifest):
                if getattr(entry, "chunks", None):
                    parsed = parse_ref_location(entry.location)
                    natural = entry.location if parsed is None else parsed[1]
                    chunked_by_natural.setdefault(natural, entry)
                    continue
                seen = by_loc.get(entry.location)
                # Keep the entry that carries the checksum, so transit
                # verification never silently checks nothing.
                if seen is None or (
                    getattr(seen, "checksum", None) is None
                    and getattr(entry, "checksum", None) is not None
                ):
                    by_loc[entry.location] = entry
            asyncio.run(
                _copy_payloads(src, dst, by_loc, chunked_by_natural, materialized_checksums, verify)
            )
            # The destination stands alone: no base references or chunk
            # records. A round-tripped copy is rewritten (the cached
            # metadata stays as it is), every entry of it, replicated
            # mirrors included.
            dest_metadata = metadata
            if metadata.base_paths:
                dest_metadata = SnapshotMetadata.from_yaml(metadata.to_yaml())
                dest_metadata.base_paths = []
                for e in _walk_all_payload_entries(dest_metadata.manifest):
                    parsed = parse_ref_location(e.location)
                    if parsed is not None:
                        e.location = parsed[1]
                    if getattr(e, "base", None) is not None:
                        e.base = None
                    if getattr(e, "chunks", None):
                        e.chunks = None
                        e.compression = None
                        e.checksum = materialized_checksums.get(e.location, e.checksum)
            asyncio.run(_write_metadata(dst, dest_metadata))
        finally:
            src.close()
            dst.close()
        return Snapshot(dest_path)

    def verify(self) -> Dict[str, str]:
        """Scrub the snapshot without touching a device: read every object
        its manifest references and check its checksum and size. Returns
        ``{location: problem}`` (empty: clean), the answer to "is this
        snapshot safe to keep, and its predecessor safe to delete?".

        A replicated value is checked once, against its writing owner's
        checksum. An object larger than 64 MiB is streamed through a
        running crc32; one without a crc32 (a non-owner's view, an
        unknown algorithm) is probed for its length only (its last byte
        and one past its end; a backend's "range not satisfiable" past
        the end is a clean end). Content chunks, borrowed ones too, are
        decoded and fingerprinted (``chunkstore.decode_and_verify_chunk``).
        Single-process."""
        storage = self._open_storage()
        problems: Dict[str, str] = {}
        try:
            metadata = self._read_metadata(storage)
            by_location: Dict[str, Tuple[Optional[str], Optional[int]]] = {}
            chunk_targets: Dict[str, Tuple[Dict[str, Any], str]] = {}
            for a in _iter_payload_entries(metadata.manifest):
                recs = getattr(a, "chunks", None)
                if recs:
                    from .chunkstore import chunk_object_path

                    base_idx = getattr(a, "base", None)
                    for rec in recs:
                        loc = chunk_object_path(rec["k"])
                        if base_idx is not None:
                            loc = make_ref_location(base_idx, loc)
                        known_rec = chunk_targets.get(loc)
                        # Prefer the record with the stored size and crc
                        # (the writing take's) over a bare reference.
                        if known_rec is None or (
                            known_rec[0].get("cs") is None and rec.get("cs") is not None
                        ):
                            chunk_targets[loc] = (rec, a.dtype)
                    continue
                checksum = getattr(a, "checksum", None)
                known = by_location.get(a.location)
                if known is None or (checksum and not known[0]):
                    by_location[a.location] = (checksum, _expected_nbytes(a))
            asyncio.run(_scrub(storage, by_location, chunk_targets, problems))
        finally:
            storage.close()
        return problems

    def _open_storage(self) -> RefRouterPlugin:
        """The snapshot's root, wrapped so that ``@base<N>/…`` locations
        (borrowed objects, content chunks) route to their roots."""
        return RefRouterPlugin(url_to_storage_plugin(self.path))

    def _available_entries(self, metadata: SnapshotMetadata, rank: int) -> Manifest:
        """``get_available_entries`` of the cached metadata, memoised."""
        available = self._available_cache.get(rank)
        if available is None:
            available = self._available_cache[rank] = get_available_entries(
                metadata.manifest, rank
            )
        return available

    def invalidate_caches(self) -> None:
        """Drop the cached metadata and the views derived from it: the
        next call reads the metadata again. :meth:`delete` calls it; call
        it after another handle or process re-took this path (a new handle
        needs none)."""
        self._metadata = None
        self._available_cache = {}

    def _read_metadata(self, storage: StoragePlugin) -> SnapshotMetadata:
        if self._metadata is None:
            self._metadata = _decorate_metadata_refs(_read_metadata_doc(storage))
            self._available_cache = {}
        metadata = self._metadata
        if metadata.base_paths and isinstance(storage, RefRouterPlugin):
            # Resolved against the current path, so a moved snapshot
            # family keeps resolving.
            storage.attach_bases([resolve_base_ref(r, self.path) for r in metadata.base_paths])
        return metadata


class _BackgroundTake:
    """The drain thread of one async take, its error and its phase."""

    def __init__(self) -> None:
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.take_id: Optional[str] = None
        # Where the drain is, for a wait() that times out: a hung storage
        # backend reads differently from a slow commit.
        self.phase = "pending"

    def start(self, fn: Callable[[], None]) -> None:
        def _run() -> None:
            try:
                fn()
            except BaseException as e:  # surfaced by PendingSnapshot.wait
                self.error = e

        self.thread = threading.Thread(target=_run, name="tpusnapshot-take")
        self.thread.start()


class PendingSnapshot:
    """Handle for an in-flight :meth:`Snapshot.async_take`."""

    def __init__(
        self,
        path: str,
        coord: Optional[Coordinator],
        background: _BackgroundTake,
        storage: StoragePlugin,
    ) -> None:
        self.path = path
        self._coord = coord
        self._background = background
        self._storage = storage
        self._result: Optional[Snapshot] = None

    def done(self) -> bool:
        thread = self._background.thread
        return thread is not None and not thread.is_alive()

    def wait(self, timeout_s: float = 1800.0) -> Snapshot:
        """Block until the snapshot is committed; idempotent. A drain
        error raises here. A drain still running after ``timeout_s``
        raises ``TimeoutError`` naming its phase; the handle stays
        usable, and a later ``wait()`` resumes."""
        if self._result is not None:
            return self._result
        # The caller is blocked on the drain: checkpoint time for goodput.
        with goodput_acct.blocked("drain_wait"):
            return self._wait(timeout_s)

    def _wait(self, timeout_s: float) -> Snapshot:
        deadline = time.monotonic() + timeout_s
        thread = self._background.thread
        if thread is not None:
            thread.join(timeout=timeout_s)
            if thread.is_alive():
                raise TimeoutError(
                    f"async_take drain did not finish within {timeout_s}s "
                    f"(stuck in phase: {self._background.phase}). The "
                    f"background thread is still running; call wait() "
                    f"again to keep waiting."
                )
        try:
            if self._background.error is None:
                # Rank 0 committed in its drain; other ranks see the
                # commit only through storage.
                asyncio.run(
                    _wait_for_metadata(
                        self._storage,
                        self._background.take_id,
                        max(0.0, deadline - time.monotonic()),
                    )
                )
        except TimeoutError:
            raise  # the storage plugin stays open for the next wait()
        except BaseException:
            self._storage.close()
            raise
        self._storage.close()
        if self._background.error is not None:
            raise self._background.error
        self._result = Snapshot(self.path, self._coord)
        return self._result


def _pop_rng_state(
    app_state: Dict[str, Stateful]
) -> Tuple[str, Optional[RNGState]]:
    """Extract the (at most one) RNGState."""
    rng_items = [
        (key, stateful)
        for key, stateful in app_state.items()
        if isinstance(stateful, RNGState)
    ]
    if len(rng_items) > 1:
        raise RuntimeError(
            f"An app_state can have at most one RNGState; got {len(rng_items)}."
        )
    if not rng_items:
        return "", None
    key, stateful = rng_items[0]
    del app_state[key]
    return key, stateful


def _gather_keys(coordinator: Coordinator, keys: List[str]) -> List[str]:
    """Sorted union of every rank's app-state keys."""
    out: Set[str] = set()
    for k in coordinator.all_gather_object(keys):
        out.update(k)
    return sorted(out)


def _safe_nbytes(value: Any) -> int:
    """Size estimate for owner balancing only; 0 means "assign by
    count" (objects, whose pickled size may differ per rank)."""
    try:
        return int(getattr(value, "nbytes", 0) or 0)
    except (TypeError, ValueError, RuntimeError):
        return 0


def _negotiate_replicated_paths(
    coordinator: Coordinator, flattened: Dict[str, Any], replicated_globs: List[str]
) -> Dict[str, int]:
    """``{path: size estimate}`` of the paths every rank matched with its
    globs (rank-divergent globs degrade to the intersection), each size
    the largest any rank estimated, so every rank derives the same owner
    map. The gather runs whenever the world is larger than one, even for
    empty globs or an absent stateful, so the ranks stay in step."""
    matched: Dict[str, int] = {}
    for path, value in flattened.items():
        if any(fnmatch.fnmatch(path, glob) for glob in replicated_globs):
            matched[path] = _safe_nbytes(value)
    if coordinator.get_world_size() == 1:
        return matched
    all_matched = coordinator.all_gather_object(sorted(matched.items()))
    inter = set(p for p, _ in all_matched[0])
    for m in all_matched[1:]:
        inter &= set(p for p, _ in m)
    sizes: Dict[str, int] = {path: 0 for path in inter}
    for m in all_matched:
        for path, size in m:
            if path in sizes:
                sizes[path] = max(sizes[path], size)
    return sizes


def _assign_replicated_owners(sizes: Dict[str, int], world_size: int) -> Dict[str, int]:
    """The rank that writes each replicated path: greedy LPT, paths in
    (size desc, path) order each to the least byte-loaded rank, so every
    rank writes about 1/N of the replicated bytes. Paths with a zero
    estimate spread by count instead. A pure function of rank-identical
    inputs: every rank computes the same map."""
    if world_size <= 1:
        return {path: 0 for path in sizes}
    byte_loads = [0] * world_size
    count_loads = [0] * world_size
    owners: Dict[str, int] = {}
    for path in sorted(sizes, key=lambda p: (-sizes[p], p)):
        size = sizes[path]
        if size > 0:
            owner = min(range(world_size), key=lambda r: byte_loads[r])
            byte_loads[owner] += size
        else:
            owner = min(range(world_size), key=lambda r: count_loads[r])
        owners[path] = owner
        count_loads[owner] += 1
    return owners


def _save_stateful(
    key: str,
    state_dict: Optional[Dict[str, Any]],
    coordinator: Coordinator,
    replicated_globs: List[str],
    manifest_out: Manifest,
    write_reqs_out: List[WriteReq],
    compression: Optional[str] = None,
) -> None:
    # A rank without this stateful still joins the negotiation (with no
    # paths), so the collective sequences of the ranks stay aligned.
    if state_dict is None:
        container_manifest: Manifest = {}
        flattened: Dict[str, Any] = {}
    else:
        container_manifest, flattened = flatten(state_dict, prefix=key)
    rank = coordinator.get_rank()
    replicated_sizes = _negotiate_replicated_paths(coordinator, flattened, replicated_globs)
    owners = _assign_replicated_owners(replicated_sizes, coordinator.get_world_size())
    manifest_out.update(container_manifest)
    for logical_path, value in sorted(flattened.items()):
        replicated = logical_path in replicated_sizes
        entry, write_reqs = prepare_write(value, logical_path, rank, replicated, compression)
        if isinstance(entry, ShardedArrayEntry) and not entry.replicated:
            # Sharded DTensors go through their own writer rule, not
            # striping (a chunked dense entry keeps its category).
            replicated = False
        manifest_out[logical_path] = entry
        if replicated and owners[logical_path] != rank:
            # Another rank writes this value; only the stored bytes'
            # checksum may be advertised, and those are the owner's.
            if hasattr(entry, "checksum"):
                entry.checksum = None
            continue
        write_reqs_out.extend(write_reqs)


def _run_reads(
    reqs: List[ReadReq],
    plans: List[ArrayRestorePlan],
    storage: StoragePlugin,
    rank: int,
    budget: int,
    stats: Dict[str, Any],
    progress: Optional[Any] = None,
) -> None:
    """Run the reads, then publish the array plans. Every plan's transfer
    failure surfaces before any remaining finalize publishes; after a
    failure no transfer is left writing when the error propagates. The
    publishing (assembly) seconds add up in ``stats["assemble_s"]``."""
    cuda = [p.region.device for p in plans if p.region.is_cuda]
    device_budget = get_device_restore_budget_bytes(cuda[0] if cuda else None)
    try:
        asyncio.run(
            execute_read_reqs(
                reqs, storage, budget, rank, device_budget_bytes=device_budget, stats=stats,
                progress=progress,
            )
        )
        for plan in plans:
            plan.await_pipeline()
    except BaseException:
        for plan in plans:
            plan.settle()
        raise
    assemble_t0 = time.monotonic()
    for plan in plans:
        plan.finalize()
    stats["assemble_s"] = stats.get("assemble_s", 0.0) + time.monotonic() - assemble_t0
    stats["region_bytes"] = stats.get("region_bytes", 0) + sum(p.region.nbytes for p in plans)
    stats["streamed_bytes"] = stats.get("streamed_bytes", 0) + sum(p.streamed_bytes for p in plans)
    stats["private_bytes"] = stats.get("private_bytes", 0) + sum(
        p.region.nbytes for p in plans if not p.region.direct
    )


def _set_restore_report(token: Any, stats: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Close the consume-profile scope; keep its block, with the read
    pipeline's numbers, in ``_last_restore_report``. Returns the profile
    as collected (None when nothing was noted)."""
    global _last_restore_report
    consume = stats.get("ops", {}).get("consume", {})
    block = _cprof.collect(token, consume_s=consume.get("seconds", 0.0))
    if block is None:
        return None
    profile = json.loads(json.dumps(block))
    block["bytes"] = consume.get("bytes", 0)
    block["scheduler"] = stats
    overlap = block["substeps"].get("h2d_overlap")
    if overlap and overlap["seconds"] > 0:
        block["h2d_overlap_gbps"] = overlap["bytes"] / 1e9 / overlap["seconds"]
    _last_restore_report = block
    return profile


# A restore's report measures the H2D link only for restores that moved at
# least this much (two small copies are noise on a large restore and pure
# overhead on a small one); 0 probes every restore.
_H2D_PROBE_MIN_BYTES_ENV_VAR = "TPUSNAPSHOT_H2D_PROBE_MIN_BYTES"
_DEFAULT_H2D_PROBE_MIN_BYTES = 64 << 20


def _finish_restore_report(
    recorder: Any,
    stats: Dict[str, Any],
    assemble_s: float,
    profile: Optional[Dict[str, Any]],
    storage: StoragePlugin,
    path: str,
    rank: int,
    coordinator: Coordinator,
) -> None:
    """Fold the read pipeline's numbers and the consume profile into the
    flight recorder, gather every rank's summary over the coordinator
    (the restore is collective already), and have rank 0 write one
    merged ``.report.restore.json`` and the ledger's restore record. The
    gather runs on every rank; the writes are best-effort (restoring
    from a read-only location must not fail)."""
    recorder.note_pipeline(stats)
    ops = stats.get("ops") or {}
    consume_agg = ops.get("consume") or {}
    consume_s = consume_agg.get("seconds", 0.0)
    recorder.add_phase("read", (ops.get("read") or {}).get("seconds", 0.0))
    recorder.add_phase("consume", consume_s)
    recorder.add_phase("assemble", assemble_s)
    try:
        if profile is not None:
            # GB/s here are GiB/s (2**30), as in the JAX package's reports.
            consumed = int(consume_agg.get("bytes", 0))
            profile["bytes"] = consumed
            probe = None
            if consume_s > 0 and consumed > 0:
                gbps = consumed / (1 << 30) / consume_s
                profile["consume_gbps"] = round(gbps, 6)
                if consumed >= env_int(_H2D_PROBE_MIN_BYTES_ENV_VAR, _DEFAULT_H2D_PROBE_MIN_BYTES):
                    from .ops.transfer import report_h2d_probe_gbps

                    probe = report_h2d_probe_gbps()
                if probe:
                    profile["h2d_probe_gbps"] = round(probe, 4)
                    profile["h2d_fraction"] = round(gbps / probe, 6)
            overlap = (profile.get("substeps") or {}).get("h2d_overlap")
            if overlap and overlap.get("seconds", 0) > 0:
                ogbps = overlap.get("bytes", 0) / (1 << 30) / overlap["seconds"]
                profile["h2d_overlap_gbps"] = round(ogbps, 6)
                if probe:
                    profile["h2d_overlap_vs_probe"] = round(ogbps / probe, 6)
            recorder.note(consume_profile=profile)
    except Exception as e:
        logger.warning("consume-profile collection failed: %r", e)
    # The state is restored by now: even the gather failing is caught on
    # every rank, and it is the restore's last collective.
    try:
        summaries = coordinator.all_gather_object(recorder.rank_summary())
        if rank == 0:
            report = flight.build_report(
                "restore", path, None, coordinator.get_world_size(), summaries
            )
            try:
                asyncio.run(flight.awrite_json(storage, flight.RESTORE_REPORT_FNAME, report))
            except Exception as e:
                logger.debug("restore flight-record write failed: %r", e)
            _ledger_append_best_effort(path, report)
    except Exception as e:
        logger.warning("restore report gather failed: %r", e)
    flight.local_export(recorder)


def _load_stateful(
    key: str,
    stateful: Stateful,
    available: Manifest,
    storage: StoragePlugin,
    rank: int,
    budget: int,
    worlds: Tuple[int, int],
    stats: Dict[str, Any],
    verify_jobs: Optional[List[Tuple[str, Entry, Any]]] = None,
    path_globs: Optional[List[str]] = None,
    progress: Optional[Any] = None,
) -> int:
    """Load one stateful; returns how many of its leaves ``path_globs``
    selected (all of them without a filter)."""
    # The template state dict supplies the devices, dtypes and shapes the
    # restored values land in (and, when they match, the tensors).
    container_manifest, flattened = flatten(stateful.state_dict(), prefix=key)
    selected = set(flattened)
    if path_globs is not None:
        selected = {p for p in flattened if any(fnmatch.fnmatch(p, g) for g in path_globs)}
        if not selected:
            # Nothing of this stateful is selected: no load_state_dict call.
            return 0
    # The RNG streams torch adds (torch/CUDA generator states) are absent
    # from a JAX-package snapshot; they then keep their current state.
    optional = isinstance(stateful, RNGState)
    reqs: List[ReadReq] = []
    plans: List[ArrayRestorePlan] = []
    for logical_path, template in list(flattened.items()):
        if logical_path not in selected:
            continue  # a partial restore: the template keeps its value
        if logical_path not in available:
            if optional:
                del flattened[logical_path]
                continue
            raise RuntimeError(
                f'Unable to find an entry for "{logical_path}" for rank '
                f"{rank}. The snapshot was taken with world size "
                f"{worlds[1]}; the restoring world size is {worlds[0]}. "
                f"Snapshots are only elastic (restorable with a different "
                f"world size) if all values are either sharded DTensors or "
                f"marked replicated at save time (per-rank values bind to "
                f"their saving process)."
            )

        def _callback(value: Any, p: str = logical_path) -> None:
            flattened[p] = value

        r, f = prepare_read(available[logical_path], template, _callback)
        reqs.extend(r)
        plans.extend(f)
    _run_reads(reqs, plans, storage, rank, budget, stats, progress)
    if verify_jobs is not None:
        for logical_path in sorted(selected & set(flattened)):
            entry = available.get(logical_path)
            if isinstance(entry, (ArrayEntry, ShardedArrayEntry)):
                verify_jobs.append((logical_path, entry, flattened[logical_path]))

    # Prefer the snapshot's container entries so saved structure (dict key
    # sets) round-trips; fall back to the template's for the rest. A
    # partial restore keeps the template's structure: its unrestored
    # subtrees hold template values the snapshot's key sets need not
    # describe.
    inflate_manifest: Manifest = {
        p: e
        for p, e in container_manifest.items()
        if not optional or p in available
    }
    if path_globs is None:
        inflate_manifest.update(
            {
                p: e
                for p, e in available.items()
                if isinstance(e, (ListEntry, DictEntry))
                and (p == key or p.startswith(key + "/"))
            }
        )
    stateful.load_state_dict(inflate(inflate_manifest, flattened, prefix=key))
    return len(selected)


def _capture(
    app_state: AppState,
    coordinator: Coordinator,
    replicated_globs: List[str],
    compression: Optional[str] = None,
) -> Tuple[Manifest, List[WriteReq]]:
    """This rank's cut of ``app_state``: its manifest (without rank
    prefixes) and the write requests of the payloads it owns. The RNG
    stateful is saved first, the others in sorted key order (the union
    of every rank's keys, each rank joining each key's collectives), and
    then the RNG streams captured are loaded back, so side effects of the
    other ``state_dict()`` calls do not reach the program."""
    app_state = dict(app_state)
    rng_key, rng_stateful = _pop_rng_state(app_state)
    manifest: Manifest = {}
    write_reqs: List[WriteReq] = []
    rng_captured = None
    rng_keys = _gather_keys(coordinator, [rng_key] if rng_stateful is not None else [])
    if rng_stateful is not None:
        rng_captured = rng_stateful.state_dict()
    for key in rng_keys:
        state_dict = rng_captured if key == rng_key else None
        _save_stateful(
            key, state_dict, coordinator, replicated_globs, manifest, write_reqs, compression
        )
    for key in _gather_keys(coordinator, sorted(app_state)):
        stateful = app_state.get(key)
        state_dict = stateful.state_dict() if stateful is not None else None
        _save_stateful(
            key, state_dict, coordinator, replicated_globs, manifest, write_reqs, compression
        )
        coordinator.barrier()
    if rng_stateful is not None:
        rng_stateful.load_state_dict(rng_captured)
    return manifest, write_reqs


class _PreStagedStager(BufferStager):
    """A payload already staged to host memory by ``stage="host"``."""

    def __init__(self, buf: Any) -> None:
        self._buf = buf

    async def stage_buffer(self, executor: Any = None) -> Any:
        return self._buf

    def get_staging_cost_bytes(self) -> int:
        # Already held in host memory: writing it frees nothing, so
        # charging its size would only throttle the drain.
        return 0


def _prestage_write_reqs(
    write_reqs: List[WriteReq], budget: int, stage: str, coordinator: Coordinator
) -> None:
    """Capture an async take's cut: device clones, or host staging.

    The choice is collective, as in the JAX package: every rank gathers
    every rank's clone result and all take the same branch."""
    cloned = stage != "host" and device_clone_write_reqs(write_reqs)
    if all(coordinator.all_gather_object(cloned)) and stage != "host":
        return
    if stage == "device":
        raise RuntimeError(
            "stage='device' was requested but the on-device clones did not "
            "fit in device memory on at least one rank. Use stage='auto' or "
            "'host'."
        )
    if stage == "auto":
        logger.warning(
            "Device-staged snapshot does not fit in device memory; falling "
            "back to host staging."
        )
    total = sum(wr.buffer_stager.get_staging_cost_bytes() for wr in write_reqs)
    if total > budget:
        logger.warning(
            f"async_take will retain ~{total // (1 << 20)} MB of staged host "
            f"buffers, exceeding the per-process memory budget "
            f"({budget // (1 << 20)} MB). If this host is RAM-constrained, "
            f"use Snapshot.take (bounded pipeline) instead."
        )

    async def _stage_all() -> None:
        with ThreadPoolExecutor(max_workers=_MAX_STAGING_THREADS) as executor:
            bufs = await asyncio.gather(
                *(wr.buffer_stager.stage_buffer(executor) for wr in write_reqs)
            )
        for wr, buf in zip(write_reqs, bufs):
            wr.buffer_stager = _PreStagedStager(buf)

    asyncio.run(_stage_all())


_COMPLETION_TIMEOUT_S = 1800.0

def _merge_manifests(all_manifests: List[Manifest]) -> Manifest:
    """Per-rank manifests as the global, rank-prefixed view, as the JAX
    package merges them: a replicated entry is mirrored into every
    rank's namespace (the stripe owner's, which carries the checksum of
    the stored bytes, preferred)."""
    merged: Manifest = {}
    replicated: Dict[str, Entry] = {}
    for rank, manifest in enumerate(all_manifests):
        for path, entry in manifest.items():
            merged[f"{rank}/{path}"] = entry
            if is_replicated(entry):
                current = replicated.get(path)
                if current is None or (
                    entry_has_content(entry) and not entry_has_content(current)
                ):
                    replicated[path] = entry
    for path, entry in replicated.items():
        for rank in range(len(all_manifests)):
            merged.setdefault(f"{rank}/{path}", entry)
    return merged


async def _read_marker(storage: StoragePlugin, path: str, nonce: str) -> Optional[Manifest]:
    """The manifest of completion marker ``path`` if it exists and belongs
    to take ``nonce``; a torn or stale document reads as absent."""
    try:
        io_req = IOReq(path=path)
        await storage.read(io_req)
    except Exception as e:
        if not is_not_found_error(e):
            raise
        return None
    try:
        doc = SnapshotMetadata.from_yaml(_decode_metadata_doc(bytes(io_payload(io_req))))
    # A torn half-committed document parses as garbage by DESIGN;
    # "no candidate" keeps the poll going until the commit lands.
    except Exception:  # snapcheck: disable=swallowed-exception -- torn-doc poll
        return None
    return doc.manifest if doc.take_id == nonce else None


async def _acommit_via_storage(
    storage: StoragePlugin,
    rank: int,
    world_size: int,
    manifest: Manifest,
    take_id: str,
    timeout_s: float = _COMPLETION_TIMEOUT_S,
    base_paths: Optional[List[str]] = None,
    snapshot_path: str = "",
    rank_summary: Optional[Dict[str, Any]] = None,
    kind: str = "take",
    progress: Optional[Any] = None,
) -> Optional[SnapshotMetadata]:
    """Commit by completion markers, as the JAX package's async drain
    does: every rank writes its manifest to ``.completed/<take_id>/<rank>``;
    rank 0 polls for every marker, merges them, writes the chunk-ref
    document of ``snapshot_path`` and then the metadata, and removes the
    markers. ``base_paths`` is the same on every rank. Returns the
    metadata on rank 0.

    ``rank_summary`` (the flight recorder's) rides storage, never the
    coordinator, which the async drain must not touch: ranks other than
    0 write ``.report/<take_id>/<rank>`` before their marker, and rank 0
    merges them into ``.report.json`` after the metadata, then appends
    the ledger record. Report IO is best-effort: it never fails the
    commit. ``progress`` (the async route's publisher) writes a rank's
    last record before its marker; rank 0 removes every rank's record
    at commit."""
    if rank_summary is not None and rank != 0:
        try:
            await flight.awrite_json(storage, flight.rank_report_path(take_id, rank), rank_summary)
        except Exception as e:
            logger.warning("flight-record summary write for rank %d failed: %r", rank, e)
    if progress is not None and rank != 0:
        # Published before the marker, so nothing republishes once rank 0
        # has swept the records.
        progress.finish()
        await progress.async_tick(force=True)
    marker = IOReq(path=f".completed/{take_id}/{rank}")
    marker.buf.write(
        _encode_metadata_doc(
            SnapshotMetadata(
                version=FORMAT_VERSION,
                world_size=world_size,
                manifest=manifest,
                take_id=take_id,
            ).to_yaml()
        )
    )
    await storage.write(marker)
    if rank != 0:
        return None
    deadline = time.monotonic() + timeout_s
    manifests: List[Manifest] = []
    for r in range(world_size):
        delay = 0.02
        while True:
            found = await _read_marker(storage, f".completed/{take_id}/{r}", take_id)
            if found is not None:
                manifests.append(found)
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"Timed out waiting for rank {r}'s completion marker "
                    f".completed/{take_id}/{r}; the snapshot is NOT committed."
                )
            await asyncio.sleep(delay)
            delay = min(delay * 2, 1.0)
    metadata = SnapshotMetadata(
        version=FORMAT_VERSION,
        world_size=world_size,
        manifest=_merge_manifests(manifests),
        take_id=take_id,
        base_paths=list(base_paths or []),
    )
    await _awrite_chunk_refs(snapshot_path, metadata)
    await _write_metadata(storage, metadata)
    # Every rank's writes are done (their markers are in), so the progress
    # records describe nothing live; this is their one deletion path.
    if progress is not None:
        await liveprog.acleanup_progress_objects(storage, take_id, world_size)
    for r in range(world_size):
        try:
            await storage.delete(f".completed/{take_id}/{r}")
        except Exception:  # a leftover marker is inert; delete() removes it
            logger.debug(f"removing .completed/{take_id}/{r} failed", exc_info=True)
    if rank_summary is not None:
        # Each summary was written before its rank's marker: one read a
        # rank, no polling. A missing one stays null in the report.
        summaries: List[Optional[Dict[str, Any]]] = [rank_summary]
        for r in range(1, world_size):
            summaries.append(await flight.aread_json(storage, flight.rank_report_path(take_id, r)))
        report = flight.build_report(kind, snapshot_path, take_id, world_size, summaries)
        try:
            await flight.awrite_json(storage, flight.REPORT_FNAME, report)
        except Exception as e:
            logger.warning("flight-record report write failed: %r", e)
        await _aledger_append_best_effort(snapshot_path, report)
        for r in range(1, world_size):
            try:
                await _delete_ignore_missing(storage, flight.rank_report_path(take_id, r))
            except Exception:  # inert, and swept by delete and reconcile
                logger.debug(
                    f"removing {flight.rank_report_path(take_id, r)} failed", exc_info=True
                )
    return metadata


async def _wait_for_metadata(
    storage: StoragePlugin, take_id: Optional[str], timeout_s: float
) -> None:
    """Poll until the metadata of take ``take_id`` is readable; a stale
    document of an earlier take at the same path does not count."""
    deadline = time.monotonic() + timeout_s
    delay = 0.02
    while True:
        try:
            io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
            await storage.read(io_req)
            try:
                metadata = SnapshotMetadata.from_yaml(
                    _decode_metadata_doc(bytes(io_payload(io_req)))
                )
            # Same torn-document contract as the nonce probe above.
            except Exception:  # snapcheck: disable=swallowed-exception -- torn-doc poll
                metadata = None
            if metadata is not None and (take_id is None or metadata.take_id == take_id):
                return
        except Exception as e:
            if not is_not_found_error(e):
                raise
        if time.monotonic() > deadline:
            raise TimeoutError(
                "Timed out waiting for the snapshot metadata commit "
                f"({SNAPSHOT_METADATA_FNAME} absent or stale)."
            )
        await asyncio.sleep(delay)
        delay = min(delay * 2, 1.0)


def _env_seconds(name: str) -> float:
    """An age guard in seconds (default 3600). Unlike other knobs, a
    malformed value raises: it is read before destructive work."""
    raw = os.environ.get(name, "3600")
    try:
        return float(raw)
    except ValueError as e:
        raise ValueError(f"Malformed {name}={raw!r}: expected seconds as a number") from e


def _read_metadata_doc(storage: StoragePlugin) -> SnapshotMetadata:
    io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
    asyncio.run(storage.read(io_req))
    return SnapshotMetadata.from_yaml(_decode_metadata_doc(bytes(io_payload(io_req))))


def _walk_all_payload_entries(manifest: Manifest):
    """Every entry that names a stored payload object, each replicated
    mirror and every shard's entry included, as they are: for rewrites in
    place (copy_to's, the ref decoration) that must not miss a mirror.
    Readers want :func:`_iter_payload_entries`."""
    for entry in manifest.values():
        if isinstance(entry, ShardedArrayEntry):
            yield from (shard.array for shard in entry.shards)
        elif isinstance(entry, (ArrayEntry, ObjectEntry)):
            yield entry


def _iter_payload_entries(manifest: Manifest):
    """The entries that name the objects this snapshot stores or
    borrows, the one definition delete, verify and copy_to share. A
    replicated path yields one entry, its writing owner's (the one with a
    checksum or chunk records): every rank's mirror names the same
    object, and after an incremental take a non-owner's mirror may name
    a location that was never written. A sharded value's shards may
    repeat a location; callers deduplicate as they need."""
    preferred: Dict[str, Entry] = {}
    for path, entry in manifest.items():
        if is_replicated(entry):
            local = path.split("/", 1)[1] if "/" in path else path
            current = preferred.get(local)
            if current is None or (entry_has_content(entry) and not entry_has_content(current)):
                preferred[local] = entry
    emitted: Set[str] = set()
    for path, entry in manifest.items():
        if is_replicated(entry):
            local = path.split("/", 1)[1] if "/" in path else path
            if local in emitted:
                continue
            emitted.add(local)
            entry = preferred[local]
        if isinstance(entry, ShardedArrayEntry):
            yield from (shard.array for shard in entry.shards)
        elif isinstance(entry, (ArrayEntry, ObjectEntry)):
            yield entry


def _expected_nbytes(entry: Any) -> Optional[int]:
    """An uncompressed array payload's stored size; None where the
    manifest does not imply one (compressed payloads, objects)."""
    if getattr(entry, "compression", None) is not None or not hasattr(entry, "dtype"):
        return None
    from .serialization import array_nbytes

    try:
        return array_nbytes(entry.dtype, entry.shape)
    except (TypeError, ValueError):
        return None


async def _scrub(
    storage: StoragePlugin,
    by_location: Dict[str, Tuple[Optional[str], Optional[int]]],
    chunk_targets: Dict[str, Tuple[Dict[str, Any], str]],
    problems: Dict[str, str],
) -> None:
    """verify()'s reads, at the backend's read fan-out."""
    from .chunkstore import decode_and_verify_chunk
    from .serialization import StreamingCrc32, verify_checksum

    sem = asyncio.Semaphore(max(1, storage.max_read_concurrency))
    scrub_chunk = _VERIFY_SCRUB_CHUNK_BYTES

    async def _probe(loc: str, start: int) -> Optional[int]:
        """Bytes a one-byte read at ``start`` returns (0 past the end);
        None after recording an unreadable object."""
        io_req = IOReq(path=loc, byte_range=(start, start + 1))
        try:
            await storage.read(io_req)
        except Exception as e:
            if is_range_not_satisfiable_error(e):
                return 0
            problems[loc] = f"unreadable: {e!r}"
            return None
        return len(io_payload(io_req))

    async def _length_only(loc: str, nbytes: int) -> None:
        # No crc to compare: probe the last byte and one past the end
        # instead of reading the object.
        last = await _probe(loc, nbytes - 1)
        if last is None:
            return
        if last != 1:
            problems[loc] = f"size mismatch: shorter than the {nbytes} bytes the manifest implies"
            return
        extra = await _probe(loc, nbytes)
        if extra:
            problems[loc] = f"size mismatch: longer than the {nbytes} bytes the manifest implies"

    async def _streamed(loc: str, checksum: Optional[str], nbytes: int, crc_ok: bool) -> None:
        crc = StreamingCrc32()
        got = 0
        for start in range(0, nbytes, scrub_chunk):
            end = min(start + scrub_chunk, nbytes)
            io_req = IOReq(path=loc, byte_range=(start, end))
            try:
                await storage.read(io_req)
            except Exception as e:
                if is_range_not_satisfiable_error(e):
                    break  # starts past the end: truncated
                problems[loc] = f"unreadable: {e!r}"
                return
            piece = io_payload(io_req)
            got += len(piece)
            crc.update(piece)
            if len(piece) < end - start:
                break  # truncated
        if got == nbytes:
            # Bytes past the manifest's size are corruption too.
            extra = await _probe(loc, nbytes)
            if extra is None:
                return
            got += extra
        if got != nbytes:
            problems[loc] = (
                f"size mismatch: stored {got} bytes (or more), manifest implies {nbytes}"
            )
        elif crc_ok and crc.tag() != checksum:
            problems[loc] = (
                f"Checksum mismatch: stored object is corrupt (expected {checksum}, "
                f"got {crc.tag()})."
            )

    async def _one(loc: str, checksum: Optional[str], nbytes: Optional[int]) -> None:
        # Only crc32 tags are checked; an unknown algorithm is skipped,
        # as verify_checksum does, leaving the length.
        crc_ok = bool(checksum and checksum.startswith("crc32:"))
        async with sem:
            if nbytes is not None and nbytes > scrub_chunk:
                if crc_ok:
                    await _streamed(loc, checksum, nbytes, crc_ok)
                else:
                    await _length_only(loc, nbytes)
                return
            io_req = IOReq(path=loc)
            try:
                await storage.read(io_req)
            except Exception as e:
                problems[loc] = f"unreadable: {e!r}"
                return
        payload = io_payload(io_req)
        if nbytes is not None and len(payload) != nbytes:
            problems[loc] = f"size mismatch: stored {len(payload)} bytes, manifest implies {nbytes}"
            return
        try:
            verify_checksum(payload, checksum)
        except Exception as e:
            problems[loc] = str(e)

    async def _one_chunk(loc: str, rec: Dict[str, Any], dtype_name: str) -> None:
        async with sem:
            io_req = IOReq(path=loc)
            try:
                await storage.read(io_req)
            except Exception as e:
                problems[loc] = f"unreadable: {e!r}"
                return
        try:
            decode_and_verify_chunk(rec, dtype_name, bytes(io_payload(io_req)))
        except Exception as e:
            problems[loc] = str(e)

    await asyncio.gather(
        *(_one(loc, cs, n) for loc, (cs, n) in by_location.items()),
        *(_one_chunk(loc, rec, dt) for loc, (rec, dt) in chunk_targets.items()),
    )


async def _copy_payloads(
    src: StoragePlugin,
    dst: StoragePlugin,
    by_loc: Dict[str, Any],
    chunked_by_natural: Dict[str, Any],
    materialized_checksums: Dict[str, str],
    verify: bool,
) -> None:
    """copy_to's transfers: at most the backends' fan-out at once, and in
    bytes at most ``TPUSNAPSHOT_COPY_BUDGET_BYTES`` in flight (an object
    larger than the budget copies alone)."""
    from .chunkstore import chunk_object_path, decode_and_verify_chunk
    from .serialization import array_nbytes, compute_checksum, verify_checksum

    sem = asyncio.Semaphore(max(1, min(src.max_read_concurrency, dst.max_write_concurrency)))
    budget = env_int("TPUSNAPSHOT_COPY_BUDGET_BYTES", 2 << 30)
    in_flight = 0
    gate = asyncio.Condition()

    async def _admit(est: int) -> None:
        nonlocal in_flight
        async with gate:
            await gate.wait_for(lambda: in_flight == 0 or in_flight + est <= budget)
            in_flight += est

    async def _release(est: int) -> None:
        nonlocal in_flight
        async with gate:
            in_flight -= est
            gate.notify_all()

    async def _one(loc: str, entry: Any) -> None:
        # An object entry's size is the backend's (a stat or HEAD, under
        # the semaphore); unknown, it is admitted at the whole budget.
        if getattr(entry, "shape", None) is not None and getattr(entry, "dtype", None):
            est = array_nbytes(entry.dtype, entry.shape)
        else:
            async with sem:
                size = await src.object_size_bytes(loc)
            est = budget if size is None else size
        await _admit(est)
        try:
            async with sem:
                io_req = IOReq(path=loc)
                await src.read(io_req)
                payload = io_payload(io_req)
                if verify:
                    # A compressed payload's checksum covers its stored
                    # bytes: exactly what is copied.
                    verify_checksum(payload, getattr(entry, "checksum", None))
                # A borrowed object lands at its own location under the
                # destination's root.
                parsed = parse_ref_location(loc)
                await dst.write(IOReq(path=loc if parsed is None else parsed[1], data=payload))
        finally:
            await _release(est)

    async def _one_chunked(natural: str, entry: Any) -> None:
        est = sum(int(r["n"]) for r in entry.chunks)
        await _admit(est)
        try:
            parts = []
            base_idx = getattr(entry, "base", None)
            for rec in entry.chunks:
                loc = chunk_object_path(rec["k"])
                if base_idx is not None:
                    loc = make_ref_location(base_idx, loc)
                async with sem:
                    io_req = IOReq(path=loc)
                    await src.read(io_req)
                # Decoding and the content check always run: the payload
                # is materialised from the decoded chunks.
                parts.append(decode_and_verify_chunk(rec, entry.dtype, bytes(io_payload(io_req))))
            payload = b"".join(parts)
            materialized_checksums[natural] = compute_checksum(payload)
            async with sem:
                await dst.write(IOReq(path=natural, data=payload))
        finally:
            await _release(est)

    await asyncio.gather(
        *(_one(loc, e) for loc, e in by_loc.items()),
        *(_one_chunked(nat, e) for nat, e in chunked_by_natural.items()),
    )


async def _delete_ignore_missing(storage: StoragePlugin, path: str) -> None:
    try:
        await storage.delete(path)
    except Exception as e:
        if not is_not_found_error(e):
            raise


# Records the JAX package keeps beside a snapshot (incremental back-links,
# flight reports, progress and sampler records, a bare snapshot's
# telemetry ledger; the hot tier's watermark is named by its runtime):
# they go with it.
_OWN_RECORD_PREFIXES = ("refs/", ".report", ".progress", ".scope/", ".telemetry/")


async def _delete_snapshot(
    storage: StoragePlugin,
    metadata: Optional[SnapshotMetadata],
    sweep: bool,
    min_age_s: float,
) -> None:
    locations: Set[str] = set()
    from .hottier.runtime import TIERDOWN_FNAME

    markers: List[str] = [TIERDOWN_FNAME]
    if metadata is not None:
        locations = {
            e.location
            for e in _iter_payload_entries(metadata.manifest)
            if getattr(e, "base", None) is None
        }
        if metadata.take_id:
            markers += [
                f".completed/{metadata.take_id}/{r}" for r in range(metadata.world_size)
            ]
    for prefix in _OWN_RECORD_PREFIXES:
        markers += await storage.list_prefix(prefix) or []
    # Uncommit first; then payloads in any order, up to the backend's
    # write concurrency.
    await _delete_ignore_missing(storage, SNAPSHOT_METADATA_FNAME)
    sem = asyncio.Semaphore(max(1, storage.max_write_concurrency))

    async def _one(path: str, guarded: bool) -> None:
        async with sem:
            if guarded and min_age_s > 0:
                try:
                    age = await storage.object_age_s(path)
                except Exception as e:  # fail closed: spare it
                    logger.warning(f"sweep: sparing {path} (age probe failed: {e!r})")
                    return
                if age is not None and age < min_age_s:
                    logger.info(
                        f"sweep: sparing {path} (age {age:.0f}s < {min_age_s:.0f}s: "
                        f"possibly a take in flight)"
                    )
                    return
            await _delete_ignore_missing(storage, path)

    known = locations | set(markers)
    await asyncio.gather(*(_one(p, False) for p in sorted(known)))
    if not sweep:
        return
    leftovers = await storage.list_prefix("")
    if leftovers is None:
        logger.warning(
            "The storage backend cannot enumerate objects; sweep skipped, "
            "orphans from interrupted takes may remain."
        )
        return
    await asyncio.gather(
        *(
            _one(p, True)
            for p in leftovers
            if p not in known and p != SNAPSHOT_METADATA_FNAME
        )
    )


async def _referencing_snapshots(
    storage: StoragePlugin, own_path: str
) -> List[Tuple[str, str]]:
    """The incremental back-links in this snapshot's
    ``refs/``: (marker path, resolved referencing snapshot URL), the URL
    empty for an unreadable marker."""
    out: List[Tuple[str, str]] = []
    for path in await storage.list_prefix("refs/") or []:
        try:
            io_req = IOReq(path=path)
            await storage.read(io_req)
            ref = json.loads(bytes(io_payload(io_req)).decode())["path"]
            out.append((path, resolve_base_ref(ref, own_path)))
        except Exception as e:
            logger.warning(f"unreadable back-link marker {path}: {e!r}")
            out.append((path, ""))
    return out


async def _live_referencers(
    storage: StoragePlugin, own_path: str, min_age_s: float
) -> Set[str]:
    """Incremental snapshots that still borrow ``own_path``'s objects: a
    back-link whose snapshot has committed metadata with entries whose
    base resolves here, or, uncommitted, a back-link younger than
    ``min_age_s`` (a take in flight; unknown age counts as young).
    Metadata that exists but cannot be read or parsed counts as live:
    only "not found" means uncommitted."""
    live: Set[str] = set()
    own = own_path.rstrip("/")
    for marker_path, ref_url in await _referencing_snapshots(storage, own_path):
        if not ref_url or ref_url.rstrip("/") in live:
            continue
        ref_storage = url_to_storage_plugin(ref_url)
        try:
            io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
            await ref_storage.read(io_req)
            md = SnapshotMetadata.from_yaml(_decode_metadata_doc(bytes(io_payload(io_req))))
        except Exception as e:
            if not is_not_found_error(e):
                # Unreadable, not absent: the referencer may be committed.
                logger.warning(f"unreadable metadata of referencer {ref_url}: {e!r}")
                live.add(ref_url.rstrip("/"))
                continue
            # Absent: in flight or stale, told apart by age.
            if min_age_s > 0:
                try:
                    age = await storage.object_age_s(marker_path)
                # Unknown age fails CLOSED (treated as live) just below.
                except Exception:  # snapcheck: disable=swallowed-exception -- fails closed
                    age = None
                if age is None or age < min_age_s:
                    live.add(ref_url.rstrip("/"))
            continue
        finally:
            ref_storage.close()
        own_idxs = {
            i
            for i, ref in enumerate(md.base_paths)
            if resolve_base_ref(ref, ref_url).rstrip("/") == own
        }
        if own_idxs and any(
            getattr(e, "base", None) in own_idxs for e in _iter_payload_entries(md.manifest)
        ):
            live.add(ref_url.rstrip("/"))
    return live


async def _gc_backlinks_in_bases(metadata: SnapshotMetadata, own_path: str) -> None:
    """After deleting an incremental snapshot, remove
    the back-links it left in its bases, so they become deletable.
    Best-effort: a base's own delete sees a stale back-link anyway."""
    own = own_path.rstrip("/")
    for ref in metadata.base_paths:
        root = resolve_base_ref(ref, own_path)
        if root.rstrip("/").endswith("/.chunkstore"):
            continue  # chunk-store GC state, not a base snapshot's back-links
        base_storage = url_to_storage_plugin(root)
        try:
            for marker_path, ref_url in await _referencing_snapshots(base_storage, root):
                if ref_url and ref_url.rstrip("/") == own:
                    await _delete_ignore_missing(base_storage, marker_path)
        except Exception as e:
            logger.warning(f"back-link GC in {root} failed: {e!r}")
        finally:
            base_storage.close()


def _encode_metadata_doc(doc: str) -> bytes:
    """The metadata document's bytes: zlib-compressed from 1 MiB on
    (``TPUSNAPSHOT_METADATA_COMPRESS_THRESHOLD``), as the JAX package
    writes it."""
    raw = doc.encode("utf-8")
    if len(raw) >= env_int("TPUSNAPSHOT_METADATA_COMPRESS_THRESHOLD", 1 << 20):
        return zlib.compress(raw, 1)
    return raw


def _decode_metadata_doc(data: bytes) -> str:
    # A zlib stream begins 0x78; the document itself begins '{' (JSON)
    # or a letter (YAML), so the formats cannot collide.
    if data[:1] == b"\x78":
        data = zlib.decompress(data)
    return data.decode("utf-8")


async def _write_metadata(storage: StoragePlugin, metadata: SnapshotMetadata) -> None:
    io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
    io_req.buf.write(_encode_metadata_doc(metadata.to_yaml()))
    await storage.write(io_req)
    # The commit point in a trace: retries and injected faults before it
    # belong to a take that never committed.
    tracing.instant(
        "metadata_committed", take_id=metadata.take_id or "", world_size=metadata.world_size
    )


def _take_telemetry(kind: str, path: str, rank: int, world_size: int) -> Tuple[Any, Any]:
    """A take's flight recorder and live progress publisher (both
    observability only: nothing fails the take through them)."""
    recorder = flight.FlightRecorder(kind=kind, path=path, rank=rank)
    tracing.set_identity(rank=rank)
    watch = liveprog.ProgressPublisher(kind=kind, path=path, rank=rank, world_size=world_size)
    telemetry.counter(
        _metric_names.TAKES_TOTAL, mode="sync" if kind == "take" else "async"
    ).inc()
    return recorder, watch


def _ledger_append_best_effort(snapshot_path: str, report: Dict[str, Any]) -> None:
    """Fold the merged flight report into a ledger digest and append it
    (rank 0, after the commit). A failed append warns and counts; it
    never fails the commit it records."""
    try:
        runledger.append_for_snapshot(snapshot_path, runledger.digest_from_report(report))
    except Exception as e:
        telemetry.counter(_metric_names.LEDGER_APPEND_FAILURES).inc()
        logger.warning("telemetry ledger append failed: %r", e)


async def _aledger_append_best_effort(snapshot_path: str, report: Dict[str, Any]) -> None:
    """:func:`_ledger_append_best_effort` inside a running event loop."""
    try:
        await runledger.aappend_for_snapshot(snapshot_path, runledger.digest_from_report(report))
    except Exception as e:
        telemetry.counter(_metric_names.LEDGER_APPEND_FAILURES).inc()
        logger.warning("telemetry ledger append failed: %r", e)


def _write_report_best_effort(storage: StoragePlugin, report: Dict[str, Any]) -> None:
    """Write a flight report; never fail the operation it describes."""
    try:
        asyncio.run(flight.awrite_json(storage, flight.REPORT_FNAME, report))
    except Exception as e:
        logger.warning("flight-record report write failed: %r", e)


async def _aread_metadata_at(url: str) -> SnapshotMetadata:
    storage = url_to_storage_plugin(url)
    try:
        io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
        await storage.read(io_req)
        return SnapshotMetadata.from_yaml(_decode_metadata_doc(bytes(io_payload(io_req))))
    finally:
        storage.close()


def _decorate_metadata_refs(metadata: SnapshotMetadata) -> SnapshotMetadata:
    """Give every entry whose payload lives in another root (a base
    snapshot, the chunk store) its routed ``@base<N>/…`` location, once
    per in-memory metadata, so every read path resolves it through the
    router. Idempotent."""
    if metadata.base_paths:
        for e in _walk_all_payload_entries(metadata.manifest):
            idx = getattr(e, "base", None)
            if idx is not None and not is_ref_location(e.location):
                e.location = make_ref_location(idx, e.location)
    return metadata


async def _awrite_chunk_refs(snapshot_path: str, metadata: SnapshotMetadata) -> None:
    from . import chunkstore

    await chunkstore.awrite_ref_for(snapshot_path, metadata)


def _write_chunk_refs(snapshot_path: str, metadata: SnapshotMetadata) -> None:
    asyncio.run(_awrite_chunk_refs(snapshot_path, metadata))


class _BaseFromRank0:
    """``base=`` of the manager on ranks other than 0: take rank 0's
    base. ``hint``, this rank's handle of the last save, lends its cached
    metadata when rank 0 names the same snapshot."""

    def __init__(self, hint: Optional["Snapshot"] = None) -> None:
        self.hint = hint


def _resolve_base_arg(base: Optional[Any]) -> Optional[Any]:
    """``base`` as a path (or the rank-0 sentinel). Never raises: checks
    run after the collation, on every rank alike."""
    if base is None or isinstance(base, _BaseFromRank0):
        return base
    return base.path if isinstance(base, Snapshot) else str(base)


def _reusable_base_metadata(base: Optional[Any], base_path: Optional[str]) -> Optional[SnapshotMetadata]:
    """A handle's cached metadata, when the handle is the agreed base:
    the incremental pass then reads no metadata."""
    if isinstance(base, _BaseFromRank0):
        base = base.hint
    if isinstance(base, Snapshot) and base_path is not None and base.path == base_path:
        return base._metadata
    return None


def _collate_incremental_args(
    coordinator: Coordinator,
    base_path: Optional[Any],
    fingerprint: Optional[bool],
    chunks: Optional[bool],
    codec: Optional[Any],
) -> Tuple[Optional[str], Optional[bool], Optional[bool], Optional[Any]]:
    """Rank 0's ``base``, ``fingerprint``, ``chunks`` and ``codec`` for
    every rank: entry ``base`` indices resolve against rank 0's merged
    ``base_paths``, so a rank deduplicating against another base would
    commit references to the wrong bytes."""
    deferred = isinstance(base_path, _BaseFromRank0)
    local = (None if deferred else base_path, fingerprint, chunks, codec)
    collated = tuple(coordinator.broadcast_object(local, src=0))
    if not deferred and collated != local:
        logger.warning(
            f"Rank {coordinator.get_rank()} passed (base, fingerprint, chunks, "
            f"codec) = {local!r} but rank 0 passed {collated!r}. Using rank 0's."
        )
    return collated


def _normalized_url(url: str) -> str:
    """``url`` with the ``fs`` scheme made explicit and its path
    normalised (``realpath`` for the filesystem, so ``..``, ``.`` and
    links compare equal)."""
    scheme, sep, rest = url.partition("://")
    if not sep:
        scheme, rest = "fs", url
    scheme = scheme or "fs"
    if scheme == "fs":
        rest = os.path.realpath(os.path.normpath(rest or "."))
    else:
        rest = posixpath.normpath(rest)
    return f"{scheme}://{rest.rstrip('/')}"


def _validate_base_path(base_path: Optional[str], path: str) -> None:
    """Refuse a take whose base is its own path, however spelled: it would
    reference objects the take is about to overwrite."""
    if base_path is not None and _normalized_url(base_path) == _normalized_url(path):
        raise ValueError(
            f"base snapshot path {base_path!r} is the take path ({path!r}); an "
            f"incremental take must write to a NEW path"
        )


def _collate_path(coordinator: Coordinator, path: str) -> str:
    """Rank 0's ``path`` for every rank: rank 0 commits the manifest, so
    a rank writing under another path would leave a snapshot that does
    not restore."""
    collated = coordinator.broadcast_object(path, src=0)
    if collated != path:
        logger.warning(
            f"Rank {coordinator.get_rank()} specified a path ({path}) different "
            f"from rank 0 ({collated}). Using rank 0's."
        )
    return collated


def _commit_via_storage_threshold() -> int:
    return env_int(_COMMIT_VIA_STORAGE_ENV_VAR, _DEFAULT_COMMIT_VIA_STORAGE_BYTES)


def _diff_verdict(a: Entry, b: Entry) -> str:
    """One logical path's verdict across two snapshots, ``a`` the older
    one's entry and ``b`` the newer one's."""
    if type(a) is not type(b):
        return "changed"
    if isinstance(a, PrimitiveEntry):
        return "unchanged" if a.readable == b.readable else "changed"
    if isinstance(a, (ArrayEntry, ShardedArrayEntry)) and (
        a.dtype != b.dtype or list(a.shape) != list(b.shape) or a.prng_impl != b.prng_impl
    ):
        return "changed"
    if isinstance(a, ArrayEntry):
        if a.fingerprint and b.fingerprint:
            return "unchanged" if a.fingerprint == b.fingerprint else "changed"
        if a.checksum and b.checksum and a.compression == b.compression:
            # Equal checksums of equal dtype and shape: unchanged.
            # Different ones prove a change only for uncompressed crc32s
            # of the logical bytes.
            if a.checksum == b.checksum:
                return "unchanged"
            if a.compression is None:
                return "changed"
        return "unknown"
    if isinstance(a, ShardedArrayEntry):
        regions_a = {(tuple(s.offsets), tuple(s.sizes)): s.array for s in a.shards}
        regions_b = {(tuple(s.offsets), tuple(s.sizes)): s.array for s in b.shards}
        if set(regions_a) != set(regions_b):
            return "unknown"  # laid out anew: no region to compare
        verdicts = {_diff_verdict(regions_a[k], regions_b[k]) for k in regions_a}
        for verdict in ("changed", "unknown"):
            if verdict in verdicts:
                return verdict
        return "unchanged"
    if isinstance(a, ObjectEntry):
        # Equal pickled bytes prove equality; different ones prove
        # nothing (pickle is not deterministic over dict and set order).
        if a.checksum and b.checksum and a.compression == b.compression and a.checksum == b.checksum:
            return "unchanged"
        return "unknown"
    return "unknown"


def _prepare_take(
    path: str,
    app_state: AppState,
    coordinator: Coordinator,
    replicated: Optional[List[str]],
    compression: Optional[str],
    base: Optional[Any],
    fingerprint: Optional[bool],
    chunks: Optional[bool],
    codec: Optional[Any],
    recorder: Any,
    watch: Any,
) -> Tuple[Manifest, List[WriteReq], List[str], Any, Dict[str, Any]]:
    """A take's cut, then its incremental pass and its chunk pass, before
    any payload is staged (so a deduplicated leaf is never copied):
    (this rank's manifest, the write requests left, ``base_paths``, the
    chunk context to clean up after the commit, or None, and the rank's
    churn note). Each pass is a phase of ``recorder`` and of the
    progress publisher ``watch``."""
    global _last_take_stats
    from . import chunkstore
    from .incremental import IncrementalStats, apply_incremental

    check_compression(compression)
    base_path, fingerprint, chunks, codec = _collate_incremental_args(
        coordinator, _resolve_base_arg(base), fingerprint, chunks, codec
    )
    _validate_base_path(base_path, path)
    watch.set_phase("capture")
    with recorder.phase("capture"):
        manifest, write_reqs = _capture(app_state, coordinator, replicated or [], compression)
    rank = coordinator.get_rank()
    record = (
        fingerprint
        if fingerprint is not None
        else (base_path is not None or env_int("TPUSNAPSHOT_FINGERPRINT", 0) != 0)
    )
    base_paths: List[str] = []
    inc = IncrementalStats()
    if base_path is not None or record:
        watch.set_phase("incremental")
        with recorder.phase("incremental"), tracing.span("Snapshot.incremental", path=path):
            base_paths, inc = apply_incremental(
                manifest, write_reqs, rank=rank, own_path=path, base_path=base_path,
                record_fingerprints=record, base_metadata=_reusable_base_metadata(base, base_path),
                coordinator=coordinator if base_path is not None else None,
            )
    # The churn note of the flight summary; without a fingerprint pass
    # everything written is "added" (basis "full").
    churn = inc.churn_note(base_path is not None)
    recorder.note(churn=churn)
    chunk_ctx = None
    stats = chunkstore.ChunkStats()
    if chunks if chunks is not None else chunkstore.chunks_enabled_default():
        watch.set_phase("chunk")
        with recorder.phase("chunk"), tracing.span("Snapshot.chunkstore", path=path):
            chunk_ctx = chunkstore.apply_chunkstore(
                manifest, write_reqs, rank=rank, own_path=path, base_paths=base_paths,
                codec_spec=codec, stats=stats,
            )
    _last_take_stats = {"incremental": inc, "chunks": stats}
    return manifest, write_reqs, base_paths, chunk_ctx, churn


def _verify_restored_fingerprints(jobs: List[Tuple[str, Entry, Any]]) -> Tuple[int, int]:
    """``restore(verify_device=True)``: recompute each restored array's
    (or shard box's) fingerprint where the manifest recorded one — one K4
    launch per device for the batch, then one fetch per device — and
    compare. The storage checksum guards storage → host; this closes
    host → device.

    A mismatch of a 4-byte dtype raises. For other widths it only warns:
    a fingerprint the JAX package recorded on another platform may pack
    sub-word elements in another order. Leaves without a fingerprint and
    lossily coded ones are skipped; the counts are kept in
    ``_last_verify_stats``."""
    global _last_verify_stats
    from .chunkstore import entry_is_lossy
    from .fingerprint import (
        fingerprint_device_async,
        fingerprint_device_many_async,
        fingerprint_host,
        resolve_fingerprints,
    )
    from .serialization import dtype_itemsize

    pending: List[Tuple[str, str, Any]] = []
    on_card: List[Tuple[int, torch.Tensor, Any]] = []  # (index in pending, tensor, slices)
    skipped = 0
    dtypes: Dict[str, str] = {}
    for path, entry, value in jobs:
        dtypes[path] = entry.dtype
        if isinstance(entry, ShardedArrayEntry):
            specs = [
                (
                    tuple(slice(o, o + n) for o, n in zip(sh.offsets, sh.sizes)),
                    None if entry_is_lossy(sh.array) else sh.array.fingerprint,
                )
                for sh in entry.shards
            ]
        else:
            specs = [(None, None if entry_is_lossy(entry) else entry.fingerprint)]
        data = value.to_local() if hasattr(value, "to_local") else value
        for slices, expected in specs:
            if expected is None:
                skipped += 1
                continue
            if isinstance(data, torch.Tensor) and data.is_cuda:
                on_card.append((len(pending), data, slices))
                pending.append((path, expected, None))
                continue
            try:
                if isinstance(data, torch.Tensor):
                    pending.append((path, expected, fingerprint_device_async(data, slices)))
                else:
                    host = data if slices is None else data[slices]
                    pending.append((path, expected, fingerprint_host(host)))
            except Exception as e:
                logger.warning(f"verify_device: cannot fingerprint {path}: {e!r}; skipping")
                skipped += 1
    if on_card:
        # One K4 launch per device; a kernel that fails to build or launch
        # fails the restore.
        results = fingerprint_device_many_async([(data, slices) for _, data, slices in on_card])
        for (i, _, _), r in zip(on_card, results):
            pending[i] = pending[i][:2] + (r,)
    device_idxs = [i for i, (_, _, r) in enumerate(pending) if not isinstance(r, str)]
    actuals = dict(zip(device_idxs, resolve_fingerprints([pending[i][2] for i in device_idxs])))
    verified = 0
    hard: List[str] = []
    soft: List[str] = []
    for i, (path, expected, result) in enumerate(pending):
        actual = result if isinstance(result, str) else actuals[i]
        if isinstance(actual, Exception):
            if isinstance(result, torch.Tensor) and result.is_cuda:
                raise actual
            logger.warning(f"verify_device: cannot resolve the fingerprint of {path}: {actual!r}; skipping")
            skipped += 1
        elif actual == expected:
            verified += 1
        else:
            try:
                four = dtype_itemsize(dtypes[path]) == 4
            except TypeError:
                four = False
            bucket = hard if four else soft
            if path not in bucket:
                bucket.append(path)
    if soft:
        logger.warning(
            f"restore(verify_device=True): fingerprint mismatch on {soft}; for "
            f"these non-4-byte dtypes it is corruption, or a fingerprint recorded "
            f"on a platform that packs sub-word elements in another order"
        )
    if hard:
        raise RuntimeError(
            f"restore(verify_device=True): restored content does not match the "
            f"manifest fingerprint for {hard}: the bytes in device memory are not "
            f"the bytes the snapshot recorded"
        )
    _last_verify_stats = {"verified": verified, "skipped": skipped}
    return verified, skipped
