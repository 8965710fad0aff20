"""Crash-point enumeration and the restore-or-detect invariant.

The harness at the heart of faultline: run a pipeline once under a pure
op counter to learn how many storage-op boundaries it crosses, then
replay it N times, crashing at every boundary (op 1, op 2, … op N —
including backend sub-steps like fs.py's write → fsync → rename →
dir-fsync), and after each crash assert the **restore-or-detect
invariant** over the surviving storage state:

  (a) every step a ``.steps/<N>`` marker names is FULLY restorable —
      ``Snapshot.verify()`` clean and a caller-supplied restore probe
      satisfied (the marker is the commit point; a marker naming a
      broken snapshot is a durability-ordering violation); and
  (b) everything else is detectably incomplete — invisible to
      ``latest_step()``/``restore()`` — and reclaimable:
      ``CheckpointManager.reconcile()`` either adopts it (committed
      metadata, missing marker: the work is finished, make it count) or
      sweeps it (no commit point: reclaim the bytes), after which a
      fresh save→prune cycle re-drives any interrupted prune and leaves
      no leaked objects.

Deterministic by construction: the schedule is a fixed op index, and a
run whose op stream comes up short of the crash point simply completes —
the invariant is checked either way.
"""

import asyncio
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..chunkstore import (
    REFS_PREFIX,
    STORE_DIRNAME,
    chunk_keys_of,
    chunk_object_path,
    ref_doc_name,
)
from ..manager import _STEP_PREFIX, CheckpointManager, _step_dir
from ..snapshot import Snapshot
from ..storage_plugin import url_to_storage_plugin
from .plugin import inject
from .schedule import FaultSchedule, SimulatedCrash
from ..telemetry.ledger import LEDGER_DIR



def count_storage_ops(scenario: Callable[[], None]) -> int:
    """Run ``scenario`` under a fault-free op counter; return how many
    storage-op boundaries it crossed (the crash-point enumeration's N)."""
    with inject(FaultSchedule()) as ctl:
        scenario()
    return ctl.op_index


@dataclass
class CrashOutcome:
    crash_op: int
    crashed: bool  # False: the op stream came up short; scenario finished
    marked_steps: List[int] = field(default_factory=list)
    adopted_steps: List[int] = field(default_factory=list)


@dataclass
class CrashMatrixReport:
    total_ops: int
    outcomes: Dict[int, CrashOutcome] = field(default_factory=dict)


def check_recovery_invariant(
    base_url: str,
    restore_probe: Callable[[int], None],
    reconcile: bool = True,
) -> CrashOutcome:
    """Assert restore-or-detect over ``base_url``'s current state.

    ``restore_probe(step)`` must restore that step and raise on any
    value mismatch. Returns which steps were marker-visible and which
    ``reconcile()`` adopted (both sets verified restorable)."""
    mgr = CheckpointManager(base_url)
    marked = mgr.all_steps()
    for step in marked:
        problems = Snapshot(_step_dir(base_url, step)).verify()
        assert not problems, (
            f"restore-or-detect violated: marker .steps/{step} names a "
            f"corrupt snapshot: {problems}"
        )
        restore_probe(step)
    adopted: List[int] = []
    if reconcile:
        mgr.reconcile(adopt=True)
        after = mgr.all_steps()
        adopted = sorted(set(after) - set(marked))
        for step in adopted:
            problems = Snapshot(_step_dir(base_url, step)).verify()
            assert not problems, (
                f"reconcile adopted step {step} but its snapshot is "
                f"corrupt: {problems}"
            )
            restore_probe(step)
    return CrashOutcome(
        crash_op=-1, crashed=False, marked_steps=marked, adopted_steps=adopted
    )


def assert_reclaimed(base_url: str, live_steps: Sequence[int]) -> None:
    """Assert storage under ``base_url`` holds ONLY the live steps'
    objects: their payload prefixes and step markers — no tombstones, no
    stray markers, no payloads of pruned or crashed takes. The leak
    check run after recovery re-drove every interrupted operation.

    The telemetry ledger (``.telemetry/``, which the JAX package writes)
    is durable metadata by contract — its records describe the run, not
    any one step, and survive prune/reconcile by design — so it is
    never a leak (torn ``*.tmp<pid>`` debris under it still is).

    The content-addressed chunk store (``.chunkstore/``, chunkstore.py)
    is leak-checked BY REFERENCE: chunk objects some live step's
    committed manifest names are allowed (they are that step's
    payload), as is each live step's ref doc; everything else under the
    store — unreferenced chunks, stale refs, intents — is a leak the
    recovery should have reclaimed."""
    live = set(live_steps)
    allowed_markers = {f"{_STEP_PREFIX}{s}" for s in live}
    allowed_prefixes = tuple(f"step-{s}/" for s in live)
    store_prefix = f"{STORE_DIRNAME}/"
    allowed_store: set = set()
    for s in sorted(live):
        step_url = _step_dir(base_url, s)
        try:
            manifest = Snapshot(step_url).get_manifest()
        # A live step whose metadata cannot be read fails the recovery
        # invariant itself; here it only shrinks the allow-set, which
        # can't hide a leak.
        except Exception:  # snapcheck: disable=swallowed-exception -- allow-set probe
            continue
        keys = chunk_keys_of(manifest)
        if keys:
            allowed_store.add(
                f"{store_prefix}{REFS_PREFIX}{ref_doc_name(step_url)}"
            )
            allowed_store.update(
                f"{store_prefix}{chunk_object_path(k)}" for k in keys
            )
    storage = url_to_storage_plugin(base_url)
    try:
        objs = asyncio.run(storage.list_prefix("")) or []
    finally:
        storage.close()

    def _is_ledger(o: str) -> bool:
        return o.startswith(f"{LEDGER_DIR}/") and not re.search(
            r"\.tmp\d+$", o
        )

    leaked = [
        o
        for o in objs
        if o not in allowed_markers
        and not o.startswith(allowed_prefixes)
        and not (o.startswith(store_prefix) and o in allowed_store)
        and not _is_ledger(o)
    ]
    assert not leaked, (
        f"leaked objects after recovery (live steps {sorted(live)}): "
        f"{sorted(leaked)}"
    )


def enumerate_crash_points(
    prepare: Callable[[], object],
    faulted: Callable[[object], None],
    check: Callable[[object, CrashOutcome], None],
    crash_points: Optional[Sequence[int]] = None,
    total_ops: Optional[int] = None,
) -> CrashMatrixReport:
    """Replay ``faulted`` crashing at every storage-op boundary.

    ``prepare()`` builds a FRESH context (new storage root, unfaulted
    history) per crash point and returns it; ``faulted(ctx)`` runs the
    pipeline under test (one save→commit→prune cycle); ``check(ctx,
    outcome)`` asserts the recovery invariant afterwards, with faults
    uninstalled. ``crash_points`` defaults to every op ``1..N`` where N
    is counted from a dry run; pass a subsample for a fast tier — the
    dry run is then SKIPPED (callers who sampled already counted; a
    whole extra pipeline run just to label the report is waste) and
    ``total_ops`` may supply the count for the report (else the largest
    sampled point stands in).
    """
    if crash_points is None:
        ctx = prepare()
        total = count_storage_ops(lambda: faulted(ctx))
        points = list(range(1, total + 1))
    else:
        points = list(crash_points)
        total = (
            total_ops
            if total_ops is not None
            else (max(points) if points else 0)
        )
    report = CrashMatrixReport(total_ops=total)
    for k in points:
        ctx = prepare()
        sched = FaultSchedule().crash_at(k)
        with inject(sched) as ctl:
            try:
                faulted(ctx)
                crashed = False
            except SimulatedCrash:
                crashed = True
        outcome = CrashOutcome(crash_op=k, crashed=crashed)
        check(ctx, outcome)
        report.outcomes[k] = outcome
    return report
