"""faultline: deterministic fault injection + crash-consistency checking.

The port of the JAX package's ``faultline``: the snapshot pipeline's
durability ordering, retry layer, commit markers, two-phase prune and
chunk GC must uphold their invariants when storage fails mid-flight.
See ``docs/FAULTS.md`` (written for the JAX package; the same model).

Three layers:

- :class:`FaultPlugin` / :func:`inject` — a ``StoragePlugin`` wrapper
  driven by a scriptable :class:`FaultSchedule`: transient cloud errors
  (429/503), permanent failures, torn writes, latency, and a hard crash
  point (op N onward raises :class:`SimulatedCrash`).
- :func:`enumerate_crash_points` / :func:`check_recovery_invariant` — run
  a save→commit→prune cycle once to count storage ops, replay it crashing
  at every op boundary (including fs.py's write→fsync→rename→dir-fsync
  sub-steps), and assert the restore-or-detect invariant after each.
- :class:`MuteRankStore` — rank-fault injection for coordinator
  collectives: a rank that never publishes must be NAMED in the healthy
  ranks' shared-deadline ``TimeoutError``, not hang them.
"""

from .crashpoints import (
    CrashMatrixReport,
    CrashOutcome,
    assert_reclaimed,
    check_recovery_invariant,
    count_storage_ops,
    enumerate_crash_points,
)
from .plugin import FaultPlugin, inject
from .rankfaults import MuteRankStore, mute_patterns_for_rank
from .schedule import (
    FaultController,
    FaultRecord,
    FaultRule,
    FaultSchedule,
    InjectedPermanentError,
    InjectedTransientError,
    SimulatedCrash,
    TornWrite,
)

__all__ = [
    "CrashMatrixReport",
    "CrashOutcome",
    "FaultController",
    "FaultPlugin",
    "FaultRecord",
    "FaultRule",
    "FaultSchedule",
    "InjectedPermanentError",
    "InjectedTransientError",
    "MuteRankStore",
    "SimulatedCrash",
    "TornWrite",
    "assert_reclaimed",
    "check_recovery_invariant",
    "count_storage_ops",
    "enumerate_crash_points",
    "inject",
    "mute_patterns_for_rank",
]
