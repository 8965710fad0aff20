"""CheckpointManager: step-indexed snapshots with retention.

One manager owns a base path. ``save(step, app_state)`` takes a snapshot
at ``<base>/step-<step>``; once it is committed, rank 0 writes a small
step marker ``<base>/.steps/<step>`` and prunes beyond ``max_to_keep``.
Markers, not directory listings, define which steps exist: a take that
was interrupted leaves no marker, so ``latest_step()`` and ``restore()``
never resolve a half-written snapshot. The layout (markers, ``.pruning/``
tombstones, ``step-<N>`` snapshots) is the JAX package's, so a run
directory written by either package's manager restores through the
other's.

``async_save`` returns a handle whose ``wait()`` writes the marker and
prunes after the background drain has committed; the training loop pays
only the stall of :meth:`Snapshot.async_take`.

``incremental=True`` bases every save on the latest committed step
(``full_period`` forces a full take every that many steps), and retention
defers a step that newer steps still borrow from. ``chunks``/``codec``
write every save through the run's ``<base>/.chunkstore``, and retention
frees chunks through the store's GC; ``reconcile`` sweeps the store and
the hot tier's orphaned RAM buffers (``hottier``).
"""

import asyncio
import logging
import re
import time
from typing import Any, List, Optional

from . import telemetry, tracing
from .coord import Coordinator, get_coordinator
from .io_types import IOReq, is_not_found_error
from .snapshot import _COMPLETION_TIMEOUT_S, PendingSnapshot, Snapshot, _BaseFromRank0
from .stateful import AppState
from .storage_plugin import url_to_storage_plugin
from .telemetry import metrics as _metric_names
from .telemetry.ledger import LEDGER_DIR
from .utils.env import env_float

logger = logging.getLogger(__name__)

_STEP_PREFIX = ".steps/"
_PRUNING_PREFIX = ".pruning/"


def _step_dir(base_path: str, step: int) -> str:
    return f"{base_path}/step-{step}"


def _sweep_min_age_s() -> float:
    return env_float("TPUSNAPSHOT_SWEEP_MIN_AGE_S", 3600.0)


def _parse_steps(paths: List[str], prefix: str, what: str) -> List[int]:
    steps = []
    for path in paths:
        try:
            steps.append(int(path[len(prefix):]))
        except ValueError:
            logger.warning(f"Ignoring malformed {what}: {path}")
    return sorted(steps)


class CheckpointManager:
    """Step-indexed snapshot lifecycle over one base path::

        mgr = CheckpointManager("/ckpt/run-7", max_to_keep=3)
        for step in range(n_steps):
            ...train...
            if step % 100 == 0:
                mgr.save(step, app_state)          # or mgr.async_save
        step = CheckpointManager("/ckpt/run-7").restore(app_state)
    """

    def __init__(
        self,
        base_path: str,
        max_to_keep: Optional[int] = None,
        keep_period: Optional[int] = None,
        coord: Optional[Coordinator] = None,
        reconcile_on_init: Optional[str] = None,
        incremental: bool = False,
        full_period: Optional[int] = None,
        chunks: Optional[bool] = None,
        codec: Optional[Any] = None,
    ) -> None:
        """``max_to_keep`` bounds the retained checkpoints; ``keep_period``
        also archives every checkpoint whose step is a multiple of it:
        archived steps never count against ``max_to_keep`` and are never
        pruned.

        ``reconcile_on_init`` ("adopt" or "sweep") runs :meth:`reconcile`
        once at construction, to recover async saves orphaned by a crash
        between their commit and their marker. Run it on one rank.

        ``incremental=True`` makes every save an incremental take based
        on the latest committed step: unchanged arrays are neither copied
        nor written. A step that newer snapshots still borrow from is kept
        past ``max_to_keep`` (with a log line) until its last referencer
        is pruned. ``full_period`` forces a full take whenever ``step %
        full_period == 0``, bounding how long an old base stays pinned.

        ``chunks``/``codec`` write every save through the content-chunk
        store at ``<base>/.chunkstore`` (defaults: ``TPUSNAPSHOT_CHUNKS``,
        ``TPUSNAPSHOT_CODEC``); consecutive saves share unchanged chunks,
        and retention frees chunks through the store's GC."""
        if full_period is not None and full_period < 1:
            raise ValueError(f"full_period must be >= 1, got {full_period}")
        if full_period is not None and not incremental:
            raise ValueError("full_period requires incremental=True")
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        if keep_period is not None and keep_period < 1:
            raise ValueError(f"keep_period must be >= 1, got {keep_period}")
        if reconcile_on_init not in (None, "adopt", "sweep"):
            raise ValueError(
                f"reconcile_on_init must be None, 'adopt', or 'sweep'; "
                f"got {reconcile_on_init!r}"
            )
        self.base_path = base_path
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.incremental = incremental
        self.full_period = full_period
        self.chunks = chunks
        self.codec = codec
        self._coord = coord
        # The last step saved through this manager and its handle, the
        # next incremental base (its cached metadata saves a read).
        self._last_saved_step: Optional[int] = None
        self._last_saved: Optional[Snapshot] = None
        if reconcile_on_init is not None:
            self.reconcile(adopt=(reconcile_on_init == "adopt"))

    # ------------------------------------------------------------- steps

    def _list(self, storage: Any, prefix: str) -> List[str]:
        found = asyncio.run(storage.list_prefix(prefix))
        if found is None:
            raise RuntimeError(
                f"The storage backend for {self.base_path} cannot enumerate "
                f"objects; CheckpointManager needs list_prefix."
            )
        return found

    def _list_steps(self, storage: Any) -> List[int]:
        return _parse_steps(self._list(storage, _STEP_PREFIX), _STEP_PREFIX, "step marker")

    def all_steps(self) -> List[int]:
        """Committed steps, ascending (storage only; no collectives)."""
        storage = url_to_storage_plugin(self.base_path)
        try:
            return self._list_steps(storage)
        finally:
            storage.close()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def reconcile(self, adopt: bool = True) -> List[int]:
        """Adopt or sweep orphaned async saves; returns the steps handled.

        A process that dies after an ``async_save`` committed but before
        ``wait()`` wrote its marker leaves a committed snapshot that no
        marker names. ``reconcile`` finds such orphans
        (``step-<N>/.snapshot_metadata`` present, ``.steps/<N>`` absent)
        and adopts them (writes the marker, then applies retention) or,
        with ``adopt=False``, deletes them, sparing orphans younger than
        ``TPUSNAPSHOT_SWEEP_MIN_AGE_S`` (a save whose ``wait()`` has not
        run yet). Steps with a ``.pruning/<N>`` tombstone are left to the
        next prune.

        In both modes it also sweeps step prefixes that hold objects but
        no commit point, no marker and no tombstone (takes that crashed
        before committing), torn ``<N>.tmp<pid>`` control files and
        orphaned progress records, each object under the same age guard.
        Storage only and single-process: run it from one rank. It lists
        the whole base prefix, so it is a recovery step, not a per-step
        one.
        """
        storage = url_to_storage_plugin(self.base_path)
        try:
            marked = set(self._list_steps(storage))
            objs = self._list(storage, "step-")
            commit = re.compile(r"^step-(\d+)/\.snapshot_metadata$")
            committed = {int(m.group(1)) for m in map(commit.match, objs) if m}
            tombstoned = set(
                _parse_steps(
                    self._list(storage, _PRUNING_PREFIX), _PRUNING_PREFIX, "prune tombstone"
                )
            )
            orphans = sorted(committed - marked - tombstoned)
            handled: List[int] = []
            if adopt:
                for step in orphans:
                    self._write_marker(storage, step)
                    logger.info(f"reconcile: adopted orphan step {step}")
                    handled.append(step)
                if handled and self.max_to_keep is not None:
                    self._prune(storage)  # adoption may overfill the window
            else:
                min_age_s = _sweep_min_age_s()
                for step in orphans:
                    if min_age_s > 0:
                        age = asyncio.run(
                            storage.object_age_s(f"step-{step}/.snapshot_metadata")
                        )
                        # Unknown age fails closed: the commit object was
                        # just listed, and may be an async save's.
                        if age is None or age < min_age_s:
                            logger.info(f"reconcile: sparing young orphan step {step}")
                            continue
                    Snapshot(_step_dir(self.base_path, step)).delete(sweep=True)
                    logger.info(f"reconcile: swept orphan step {step}")
                    handled.append(step)
            handled.extend(
                self._reclaim_uncommitted(storage, objs, committed | marked | tombstoned)
            )
            self._sweep_debris(storage, objs)
            self._reconcile_hot_tier(committed, marked, tombstoned)
            self._reconcile_chunkstore(storage)
            return handled
        finally:
            storage.close()

    def _reclaim_uncommitted(self, storage: Any, objs: List[str], known: set) -> List[int]:
        """Sweep step prefixes that hold objects but no commit point;
        returns the steps whose prefixes came out empty."""
        step_pat = re.compile(r"^step-(\d+)/")
        seen = {int(m.group(1)) for m in map(step_pat.match, objs) if m}
        reclaimed: List[int] = []
        for step in sorted(seen - known):
            try:
                Snapshot(_step_dir(self.base_path, step)).delete(sweep=True)
                remaining = self._list(storage, f"step-{step}/")
            except Exception as e:
                logger.warning(
                    f"reconcile: reclaiming uncommitted step {step} failed "
                    f"({e!r}); retried on the next reconcile."
                )
                continue
            if remaining:
                logger.info(
                    f"reconcile: uncommitted step {step}: {len(remaining)} "
                    f"object(s) spared by the sweep age guard."
                )
            else:
                logger.info(f"reconcile: reclaimed uncommitted step {step}")
                reclaimed.append(step)
        return reclaimed

    def _sweep_debris(self, storage: Any, objs: List[str]) -> None:
        """Remove torn ``<N>.tmp<pid>`` control files (a crash between the
        fs plugin's write and rename), ``*.tmp<pid>`` debris of ledger
        appends (never the ledger itself: its committed records are
        durable metadata), and progress/sampler records of takes that
        crashed mid-drain, each spared while younger than
        ``TPUSNAPSHOT_SWEEP_MIN_AGE_S`` (unknown age fails closed)."""
        doomed = [
            obj
            for prefix in (_STEP_PREFIX, _PRUNING_PREFIX)
            for obj in self._list(storage, prefix)
            if re.fullmatch(r"\d+\.tmp\d+", obj[len(prefix):])
        ]
        doomed += [o for o in self._list(storage, LEDGER_DIR + "/") if re.search(r"\.tmp\d+$", o)]
        doomed += [o for o in objs if re.match(r"^step-\d+/(\.progress|\.scope)/", o)]
        min_age_s = _sweep_min_age_s()
        for obj in doomed:
            if min_age_s > 0:
                try:
                    age = asyncio.run(storage.object_age_s(obj))
                except Exception as e:
                    logger.warning(f"reconcile: sparing {obj} (age probe failed: {e!r})")
                    continue
                if age is None or age < min_age_s:
                    continue
            try:
                asyncio.run(storage.delete(obj))
                logger.info(f"reconcile: removed debris {obj}")
            except Exception as e:
                if not is_not_found_error(e):
                    logger.warning(f"reconcile: removing {obj} failed ({e!r})")

    def _reconcile_hot_tier(self, committed: set, marked: set, tombstoned: set) -> None:
        """Sweep orphaned hot-tier RAM buffers: steps with neither
        committed metadata nor a marker (a take that crashed before its
        commit) or condemned by a prune have buffers nothing will read or
        drain. The keep-set is committed ∪ marked less the tombstoned, so
        a committed take not yet drained keeps its replicas; young
        uncommitted roots are spared by ``TPUSNAPSHOT_SWEEP_MIN_AGE_S``.
        Best-effort: a tier failure never fails reconcile."""
        try:
            from . import hottier

            keep = {_step_dir(self.base_path, s) for s in (committed | marked) - tombstoned}
            for root in hottier.reconcile_hot_tier(self.base_path, keep):
                logger.info(f"reconcile: dropped orphaned hot-tier buffers for {root}")
        except Exception as e:
            logger.warning(f"reconcile: hot-tier buffer sweep failed: {e!r}")

    def _reconcile_chunkstore(self, storage: Any) -> None:
        """Sweep the run's chunk store (stale intents, stale ref documents,
        unreferenced chunks): the re-drive of any chunk GC a crashed
        delete left half done. Best-effort, like every debris pass."""
        try:
            if not self._list(storage, ".chunkstore/"):
                return
            from . import chunkstore

            chunkstore.reconcile_store(self.base_path)
        except Exception as e:
            logger.warning(f"reconcile: chunk-store sweep failed: {e!r}")

    # -------------------------------------------------------------- save

    def _incremental_base(self, step: int, coordinator: Coordinator) -> Optional[Any]:
        """The base of an incremental save, or None for a full take. Rank 0
        resolves it (the take collates it); the other ranks pass the
        sentinel with their last handle as a hint. The handle of the step
        this manager just saved stands in for its path."""
        if not self.incremental:
            return None
        if self.full_period is not None and step % self.full_period == 0:
            return None
        if coordinator.get_rank() != 0:
            return _BaseFromRank0(hint=self._last_saved)
        latest = self.latest_step()
        if latest is None or latest >= step:
            # No committed base, or a re-saved step: a full take rather
            # than a reference to "the future".
            return None
        if latest == self._last_saved_step and self._last_saved is not None:
            return self._last_saved
        return _step_dir(self.base_path, latest)

    def save(
        self,
        step: int,
        app_state: AppState,
        replicated: Optional[List[str]] = None,
        compression: Optional[str] = None,
    ) -> Snapshot:
        """Take a snapshot for ``step``; commit its marker; prune.
        ``replicated`` and ``compression`` are :meth:`Snapshot.take`'s."""
        coordinator = get_coordinator(self._coord)
        # The take's trace scope covers the finalize too (the take joins it).
        with tracing.trace_scope("take"):
            snapshot = Snapshot.take(
                _step_dir(self.base_path, step),
                app_state,
                coord=coordinator,
                replicated=replicated,
                compression=compression,
                base=self._incremental_base(step, coordinator),
                fingerprint=True if self.incremental else None,
                chunks=self.chunks,
                codec=self.codec,
            )
            self._finalize(step, coordinator)
        # Every rank keeps the handle: the merged metadata seeded its cache.
        self._last_saved_step, self._last_saved = step, snapshot
        return snapshot

    def async_save(
        self,
        step: int,
        app_state: AppState,
        replicated: Optional[List[str]] = None,
        *,
        compression: Optional[str] = None,
        stage: str = "auto",
    ) -> "PendingManagedSnapshot":
        """Async take for ``step``; the handle's ``wait()`` writes the
        marker and prunes after the drain commits. Dropping the handle
        without waiting leaves the step invisible (no marker) and
        unpruned, until :meth:`reconcile` adopts it. ``compression`` and
        ``stage`` are :meth:`Snapshot.async_take`'s, keyword-only as
        there."""
        coordinator = get_coordinator(self._coord)
        pending = Snapshot.async_take(
            _step_dir(self.base_path, step),
            app_state,
            coord=coordinator,
            replicated=replicated,
            compression=compression,
            stage=stage,
            base=self._incremental_base(step, coordinator),
            fingerprint=True if self.incremental else None,
            chunks=self.chunks,
            codec=self.codec,
        )
        return PendingManagedSnapshot(self, step, pending, coordinator)

    def _write_marker(self, storage: Any, step: int) -> None:
        marker = IOReq(path=f"{_STEP_PREFIX}{step}")
        marker.buf.write(_step_dir(self.base_path, step).encode())
        asyncio.run(storage.write(marker))

    def _finalize(self, step: int, coordinator: Coordinator) -> None:
        # The marker (rank 0) is the correctness-bearing part: write it,
        # release the other ranks, and only then prune. The barrier runs
        # in a finally, so a failed marker write releases them too.
        storage = None
        with tracing.span("CheckpointManager.finalize", step=step):
            try:
                try:
                    if coordinator.get_rank() == 0:
                        storage = url_to_storage_plugin(self.base_path)
                        with tracing.span("marker"):
                            marker_t0 = time.monotonic()
                            self._write_marker(storage, step)
                            telemetry.histogram(
                                _metric_names.MANAGER_STEP_MARKER_SECONDS
                            ).observe(time.monotonic() - marker_t0)
                        # From here the step resolves and must restore clean.
                        tracing.instant("step_marker_committed", step=step)
                finally:
                    coordinator.barrier(_COMPLETION_TIMEOUT_S)
                if storage is not None and self.max_to_keep is not None:
                    with tracing.span("prune"):
                        self._prune(storage)
            finally:
                if storage is not None:
                    storage.close()

    def _prune(self, storage: Any) -> None:
        prune_t0 = time.monotonic()
        try:
            self._prune_steps(storage)
        finally:
            telemetry.histogram(_metric_names.MANAGER_PRUNE_SECONDS).observe(
                time.monotonic() - prune_t0
            )

    def _prune_steps(self, storage: Any) -> None:
        # Two phases with a tombstone, so the NEXT prune re-drives an
        # interrupted one instead of leaking the step's payloads:
        #   1. write .pruning/<step>
        #   2. delete the .steps/<step> marker (the step is now invisible)
        #   3. delete the step's snapshot
        #   4. delete the tombstone once the step's prefix is empty
        steps = self._list_steps(storage)
        if self.keep_period is not None:
            steps = [s for s in steps if s % self.keep_period != 0]
        doomed = steps[: -self.max_to_keep]
        doomed += _parse_steps(
            self._list(storage, _PRUNING_PREFIX), _PRUNING_PREFIX, "prune tombstone"
        )
        # Newest first: an incremental chain's referencers are newer than
        # their base, so a doomed chain is released in one pass.
        for step in sorted(set(doomed), reverse=True):
            snapshot = Snapshot(_step_dir(self.base_path, step))
            try:
                # A step that a live incremental snapshot still borrows
                # from is deferred, keeping its marker:
                # max_to_keep is exceeded visibly, not silently.
                try:
                    referenced = snapshot.is_referenced()
                except Exception as e:
                    logger.warning(
                        f"Prune of step {step}: reference check failed ({e!r}); deferring."
                    )
                    referenced = True
                if referenced:
                    logger.info(
                        f"Prune of step {step} deferred: still referenced by "
                        f"incremental snapshot(s)."
                    )
                    continue
                tomb = IOReq(path=f"{_PRUNING_PREFIX}{step}")
                tomb.buf.write(b"1")
                asyncio.run(storage.write(tomb))
                try:
                    asyncio.run(storage.delete(f"{_STEP_PREFIX}{step}"))
                except Exception as e:
                    if not is_not_found_error(e):
                        raise
                snapshot.delete(sweep=True)
                telemetry.counter(_metric_names.MANAGER_STEPS_PRUNED).inc()
                # The sweep spares young unreferenced objects; the
                # tombstone stays until the prefix is empty, and a later
                # prune retries.
                remaining = self._list(storage, f"step-{step}/")
                if remaining:
                    logger.info(
                        f"Prune of step {step}: {len(remaining)} object(s) "
                        f"spared by the sweep age guard; keeping its tombstone "
                        f"for a later retry."
                    )
                else:
                    asyncio.run(storage.delete(f"{_PRUNING_PREFIX}{step}"))
            except Exception as e:
                logger.warning(
                    f"Pruning step {step} failed ({e!r}); its tombstone "
                    f"remains and the next prune retries it."
                )

    # ------------------------------------------------------------ restore

    def restore(
        self,
        app_state: AppState,
        step: Optional[int] = None,
        paths: Optional[List[str]] = None,
    ) -> int:
        """Restore ``app_state`` from ``step`` (default: the latest);
        returns the step restored. The latest step is resolved on rank 0
        and broadcast, so a racing prune cannot split the ranks.
        ``paths`` restores only the matching leaves, as
        :meth:`Snapshot.restore` does."""
        coordinator = get_coordinator(self._coord)
        # The restore's trace scope and root span (the snapshot's joins it).
        with tracing.trace_scope("restore"), tracing.span("CheckpointManager.restore", step=step):
            if step is None:
                chosen = self.latest_step() if coordinator.get_rank() == 0 else None
                step = coordinator.broadcast_object(chosen, src=0)
                if step is None:
                    raise FileNotFoundError(
                        f"No committed checkpoints under {self.base_path} "
                        f"(no {_STEP_PREFIX}* markers)."
                    )
            Snapshot(_step_dir(self.base_path, step)).restore(
                app_state, coord=coordinator, paths=paths
            )
        return step


class PendingManagedSnapshot:
    """Handle for :meth:`CheckpointManager.async_save`."""

    def __init__(
        self,
        manager: CheckpointManager,
        step: int,
        pending: PendingSnapshot,
        coordinator: Coordinator,
    ) -> None:
        self._manager = manager
        self._step = step
        self._pending = pending
        self._coordinator = coordinator
        self._finalized = False

    def done(self) -> bool:
        return self._pending.done()

    def wait(self, timeout_s: float = 1800.0) -> Snapshot:
        with tracing.adopt_trace(self._pending.trace_id), tracing.span(
            "CheckpointManager.wait", step=self._step
        ):
            snapshot = self._pending.wait(timeout_s=timeout_s)
            if not self._finalized:
                # Flagged after success: a failed marker write is retried by
                # the next wait().
                self._manager._finalize(self._step, self._coordinator)
                self._finalized = True
                self._manager._last_saved_step = self._step
                self._manager._last_saved = snapshot
        return snapshot
