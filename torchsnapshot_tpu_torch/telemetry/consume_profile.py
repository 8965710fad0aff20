"""Consume micro-profiler: where the time of a restore's consume goes.

Every host→device transfer of the port's restore runs on the H2D
pipeline, so the JAX package's in-consume ``device_put`` and codec
``decode`` sub-steps have no counterpart here.

The restore root opens a contextvar-scoped :class:`ConsumeProfile`; every
buffer consumer captures it when its plan is built (in the restoring
thread) and notes sub-steps into it from the executor threads:

==================  ====================================================
sub-step            what it times
==================  ====================================================
read_wait           a completed read's payload queued in the scheduler
                    before its consume dispatched (host or device budget,
                    executor pressure; not part of the consume wall)
deserialize         pickled-object loads
verify              checksum verification and streaming crc folds
reassemble          host memcpy: a payload into a pooled (pinned) staging
                    buffer, sub-reads into an assembly buffer, a box of
                    a host payload into a host target
staging_release     returning assembly buffers to the pool and
                    re-crediting scheduler budget
pool_wait           waiting for a staging-pool buffer at pool capacity
h2d_overlap         the H2D pipeline's transfer wall (ops/transfer.py
                    ``H2DPipeline``), UNION time across its workers, so
                    bytes / seconds is the delivered link rate; beside
                    the consume wall, not in it
overlap_other       in-consume-named work that ran outside a consume
                    section (a leaf's publish on a pipeline or finalize
                    thread), kept apart from h2d_overlap
other               consume wall the sub-steps above do not account for
                    (scheduling, GIL waits), computed at collect time so
                    the in-consume sub-steps plus ``other`` sum to the
                    consume wall
==================  ====================================================

Cost: one ``time.monotonic()`` pair per noted sub-step per piece. While
tracing is on, each noted sub-step is also a ``consume.<sub-step>`` span
and each H2D transfer a ``consume.h2d_overlap`` span (as in the JAX
package; ``telemetry/summarize.py`` folds them), on whatever thread runs
it, under the trace id and parent that thread carries: recorded from the
same clock readings with ``tracing.complete``, since these run by the
thousand on the restore's threads, under the interpreter lock.
"""

import contextvars
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

from .. import tracing

# Sub-steps inside consume_buffer (they reconcile with the scheduler's
# consume seconds); the overlap sub-steps happen beside the consume wall.
IN_CONSUME_SUBSTEPS = (
    "deserialize",
    "verify",
    "reassemble",
    "staging_release",
    "pool_wait",
)
OVERLAP_SUBSTEPS = ("read_wait", "h2d_overlap", "overlap_other")


class ConsumeProfile:
    """Thread-safe sub-step accumulator for ONE restore."""

    __slots__ = ("_lock", "_agg", "_ov_active", "_ov_start")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # substep -> [count, seconds, bytes]
        self._agg: Dict[str, list] = {}
        # Union-time clock of h2d_overlap: seconds advance while at least
        # one transfer of this restore is in flight, so concurrent
        # workers do not multiply the seconds (and divide the GB/s).
        self._ov_active = 0
        self._ov_start = 0.0

    def note(self, substep: str, seconds: float, nbytes: int = 0) -> None:
        with self._lock:
            entry = self._agg.get(substep)
            if entry is None:
                entry = self._agg[substep] = [0, 0.0, 0]
            entry[0] += 1
            entry[1] += seconds
            entry[2] += nbytes

    def _overlap_enter(self) -> None:
        with self._lock:
            if self._ov_active == 0:
                self._ov_start = time.monotonic()
            self._ov_active += 1

    def _overlap_exit(self, nbytes: int) -> None:
        with self._lock:
            self._ov_active -= 1
            entry = self._agg.get("h2d_overlap")
            if entry is None:
                entry = self._agg["h2d_overlap"] = [0, 0.0, 0]
            entry[0] += 1
            entry[2] += nbytes
            if self._ov_active == 0:
                entry[1] += time.monotonic() - self._ov_start

    def summary(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                substep: {"count": entry[0], "seconds": entry[1], "bytes": entry[2]}
                for substep, entry in sorted(self._agg.items())
            }


_SCOPE: "contextvars.ContextVar[Optional[ConsumeProfile]]" = contextvars.ContextVar(
    "tpusnapshot_torch_consume_profile", default=None
)

# Thread-local consume-section marker: consumer executor bodies run inside
# consume_section(), so a note made elsewhere (the same code run from a
# pipeline callback) folds into overlap_other and the in-consume
# sub-steps keep summing to the consume wall.
_SECTION = threading.local()


@contextmanager
def consume_section():
    prev = getattr(_SECTION, "active", False)
    _SECTION.active = True
    try:
        yield
    finally:
        _SECTION.active = prev


def in_consume_section() -> bool:
    return getattr(_SECTION, "active", False)


def _route(name: str) -> str:
    if name in IN_CONSUME_SUBSTEPS and not in_consume_section():
        return "overlap_other"
    return name


def begin() -> Tuple[ConsumeProfile, Any]:
    """Open a per-restore profiling scope in the restoring thread."""
    profile = ConsumeProfile()
    return profile, _SCOPE.set(profile)


def current() -> Optional[ConsumeProfile]:
    """The active profile, captured by consumers when a plan is built."""
    return _SCOPE.get()


def collect(token: Any, consume_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Close the scope and build the profile block. ``consume_s`` (the
    scheduler's consume seconds for this restore) yields the ``other``
    bucket. None when nothing was noted (a restore of primitives only)."""
    if token is None:
        return None
    profile, var_token = token
    try:
        _SCOPE.reset(var_token)
    except ValueError:
        pass  # reset from another context: the scope is collected anyway
    substeps = profile.summary()
    if not substeps and not consume_s:
        return None
    block: Dict[str, Any] = {"substeps": substeps}
    accounted = sum(substeps.get(s, {}).get("seconds", 0.0) for s in IN_CONSUME_SUBSTEPS)
    block["accounted_s"] = accounted
    if consume_s is not None:
        block["consume_s"] = consume_s
        block["substeps"]["other"] = {
            "count": 0,
            "seconds": max(0.0, consume_s - accounted),
            "bytes": 0,
        }
    return block


@contextmanager
def overlap_span(profile: Optional[ConsumeProfile], nbytes: int = 0):
    """Time one H2D pipeline transfer into ``h2d_overlap`` (union time)."""
    if profile is None:
        yield
        return
    profile._overlap_enter()
    t0 = time.monotonic() if tracing.enabled() else None
    try:
        yield
    finally:
        profile._overlap_exit(nbytes)
        if t0 is not None:
            tracing.complete("consume.h2d_overlap", t0, time.monotonic(), bytes=nbytes)


@contextmanager
def substep(profile: Optional[ConsumeProfile], name: str, nbytes: int = 0):
    """Time one sub-step into ``profile``; a passthrough when no restore
    scope is active."""
    if profile is None:
        yield
        return
    name = _route(name)
    t0 = time.monotonic()
    try:
        yield
    finally:
        t1 = time.monotonic()
        profile.note(name, t1 - t0, nbytes)
        if tracing.enabled():
            tracing.complete(f"consume.{name}", t0, t1, bytes=nbytes)
