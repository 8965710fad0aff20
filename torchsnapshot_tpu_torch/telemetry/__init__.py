"""Telemetry of the port: always-on metrics, the per-snapshot flight
recorder, live progress records, the cross-take ledger, and the tools
that read them, in the JAX package's formats (a snapshot either package
takes carries the same telemetry objects, and each package's tools read
the other's).

- **Metrics** (:mod:`.metrics`): process-wide counters, gauges and
  log-bucketed histograms, thread-safe; ``telemetry.snapshot()`` returns
  them as plain data.
- **Exporters** (:mod:`.export`): the Prometheus textfile and JSON lines
  (``TPUSNAPSHOT_METRICS_TEXTFILE`` / ``TPUSNAPSHOT_TELEMETRY_JSONL``
  export after every take and restore).
- **Flight recorder** (:mod:`.report`): every take writes
  ``.report.json`` beside the manifest, every restore
  ``.report.restore.json``; ``python -m torchsnapshot_tpu_torch.inspect
  <path> --report`` renders it.
- **Live progress** (:mod:`.progress`): per-rank records
  (``.progress/<take_id>/<rank>`` and a local statusfile).
- **Ledger** (:mod:`.ledger`): a checksummed digest of every committed
  take and restore in ``<root>/.telemetry/ledger.jsonl``.
- **Goodput** (:mod:`.goodput`), **memwatch** (:mod:`.memwatch`: host
  memory domains and the overcommit forecast), **doctor**
  (:mod:`.doctor`), **timeline** (:mod:`.timeline`), **SLOs**
  (:mod:`.slo`), the trace summary (:mod:`.summarize`) and the restore's
  consume profile (:mod:`.consume_profile`).
- **watch** (:mod:`.watch`): ``python -m
  torchsnapshot_tpu_torch.telemetry.watch <path>`` renders live progress
  records and flags stale-heartbeat stragglers.
- **merge** (:mod:`.merge`): N per-process traces onto one skew-corrected
  clock, with the cross-process critical path.
- **sampler** (:mod:`.sampler`): a background thread snapshotting live
  runtime state (hot tier, wire, memory domains, goodput) into a ring and
  ``rank<N>.scope.jsonl`` statusfiles.
- **ops** (:mod:`.ops`): ``python -m torchsnapshot_tpu_torch.telemetry.ops
  <path>`` merges live progress, sampler state, SLO status, doctor
  findings and the stats of live read-plane servers and hot-tier peers
  into one operational view.

:mod:`.report` is not imported here: it depends on ``io_types``, which
records metrics through this package. Import it explicitly
(``from torchsnapshot_tpu_torch.telemetry import report``).
"""

import time
from typing import Any, Dict, Optional

from . import metrics as _m
from . import goodput  # noqa: F401  (telemetry.goodput.step() is the train-loop hook)
from .metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    diff_snapshots,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "goodput",
    "histogram",
    "snapshot",
    "reset",
    "diff_snapshots",
    "record_storage_op",
    "record_scheduler_op",
    "record_coord_wait",
    "timer",
]


def counter(name: str, **labels: str) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: str) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels: str) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def snapshot() -> Dict[str, Any]:
    """Every metric's current value as plain (JSON-able) data — the
    programmatic export API."""
    return REGISTRY.snapshot()


def reset() -> None:
    """Drop all metrics (test isolation; never called by library code)."""
    REGISTRY.reset()


class timer:
    """``with telemetry.timer() as t: ...`` then ``t.elapsed_s``."""

    __slots__ = ("t0", "elapsed_s")

    def __enter__(self) -> "timer":
        self.t0 = time.monotonic()
        self.elapsed_s = 0.0
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed_s = time.monotonic() - self.t0


# ----------------------------------------------------- recording shorthands
#
# One-call helpers for the instrumented seams, so call sites stay one
# line and the metric names live in exactly one place (metrics.py).


def record_storage_op(
    backend: str, op: str, seconds: float, nbytes: Optional[int] = None
) -> None:
    """One storage-plugin op completed (fs/memory/gcs/s3 write/read/...)."""
    REGISTRY.histogram(_m.STORAGE_OP_SECONDS, backend=backend, op=op).observe(
        seconds
    )
    if nbytes is not None:
        REGISTRY.histogram(
            _m.STORAGE_OP_BYTES, backend=backend, op=op
        ).observe(nbytes)


def record_scheduler_op(op: str, seconds: float, nbytes: int) -> None:
    """One pipelined request op completed (stage/write/read/consume)."""
    REGISTRY.histogram(_m.SCHED_OP_SECONDS, op=op).observe(seconds)
    REGISTRY.histogram(_m.SCHED_OP_BYTES, op=op).observe(nbytes)


def record_coord_wait(op: str, seconds: float) -> None:
    """One coordinator collective completed (barrier/all_gather/broadcast)."""
    REGISTRY.histogram(_m.COORD_WAIT_SECONDS, op=op).observe(seconds)
