"""Lightweight span tracing for snapshot phases (beyond reference parity).

The reference's only instrumentation is per-rank throughput logging
(reference scheduler.py:151-152; SURVEY §5 "Tracing/profiling: none").
Here every take/restore phase and every staged/written/read/consumed
request can emit a timed span into a Chrome-trace JSON
(``chrome://tracing`` / Perfetto-loadable), so "why was this snapshot
slow" is answerable from a file instead of a guess.

Enable via env — zero overhead when disabled (one None check per span):

    TPUSNAPSHOT_TRACE=/tmp/snapshot-trace.json python train.py

or programmatically::

    from torchsnapshot_tpu_torch import tracing
    tracing.enable("/tmp/trace.json")
    ... Snapshot.take(...) ...
    tracing.flush()

Spans are recorded as Chrome-trace *async* events ("b"/"e" with a unique
id): the scheduler runs many stage/write/read spans concurrently on one
event-loop thread, and async events render each span on its own lane
where same-track duration events would overlap and garble the timeline.

Multi-process runs: each process writes its own file — the env path gets
a ``.pid<N>`` suffix, plus a role tag when ``TPUSNAPSHOT_TRACE_ROLE``
is set (or substitute ``{pid}``/``{role}`` in the path yourself);
``enable(path)`` writes exactly ``path``. ``flush()`` is fork-safe: a
child process inheriting an enabled tracer re-suffixes its output with
its OWN pid, so it can never clobber the parent's trace file.

Causal context (snapxray): :func:`trace_scope` stamps a contextvar
trace id at each take/restore root; every span/instant recorded while
the context is active carries ``args.trace``, and :func:`flow_start` /
:func:`flow_step` / :func:`flow_end` emit Perfetto flow events
(``ph: s/t/f``) whose shared id links spans ACROSS processes — a
RemoteSnapshot restore's client spans, the snapserve server's cache and
backend-fetch spans, and the hot tier's background drain all join one
causal chain (``telemetry/merge.py`` draws the arrows and computes the
cross-process critical path). Context generation is independent of
whether THIS process records events: a tracing-off client still
propagates ids so a tracing-on server can attribute its spans.

Causal parents: the begin event of every span names, as a top-level
``parent`` beside its ``id``, the innermost span open in its context
when it began. Asyncio tasks inherit it with the context; work handed to
another thread (an executor, a pipeline worker, a drain) keeps it with
:func:`carry` or ``adopt_trace(trace_id, parent=...)``.

Clock: ``metadata.clock_epoch_s`` is the wall-clock time of ts 0, read
with the monotonic anchor as one tight pair (:func:`_clock_pair`), so an
event's wall time is ``clock_epoch_s + ts/1e6`` to within microseconds.
A Chrome trace of ``torch.profiler`` carries ``baseTimeNanoseconds``
(the wall time of its ts 0), so the two put onto one timeline as
``profiler_us = clock_epoch_s*1e6 + ts - baseTimeNanoseconds/1e3``.
"""

import atexit
import contextvars
import itertools
import json
import os
import socket
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

_TRACE_ENV_VAR = "TPUSNAPSHOT_TRACE"
_TRACE_ROLE_ENV_VAR = "TPUSNAPSHOT_TRACE_ROLE"

_lock = threading.Lock()
_events: Optional[List[Dict[str, Any]]] = None
_path: Optional[str] = None
_t0: float = 0.0
# Wall-clock epoch captured at the same instant as _t0, so any event's
# monotonic ts maps to an absolute time: wall = _wall0 + ts/1e6. The
# cross-rank merge (telemetry/merge.py) aligns per-rank traces on it.
_wall0: float = 0.0
_rank: Optional[int] = None
_role: Optional[str] = None
# Pid at enable time: flush() compares against os.getpid() so a forked
# child re-suffixes instead of clobbering the parent's file.
_pid_at_enable: int = 0
_span_ids = itertools.count(1)
_flow_seq = itertools.count(1)

# The ambient causal context: the trace id stamped at the nearest
# enclosing take/restore root (None outside any root). Propagates into
# asyncio tasks automatically; executor threads and background drains
# adopt it explicitly (adopt_trace / per-object capture).
_TRACE_CTX: "contextvars.ContextVar[Optional[str]]" = (
    contextvars.ContextVar("tpusnapshot_trace_ctx", default=None)
)
# The innermost open span's id in this context (None outside any span, and
# always while tracing is off): the ``parent`` of the next span to begin.
_SPAN_CTX: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "tpusnapshot_span_ctx", default=None
)
# Bracketings tried for the monotonic/wall anchor pair.
_CLOCK_PAIR_READS = 5


def set_identity(
    rank: Optional[int] = None, role: Optional[str] = None
) -> None:
    """Record this process's rank (and optionally its role — e.g.
    ``"server"`` for a snapserve process) for the trace metadata. Called
    by the snapshot paths the moment a coordinator resolves (cheap,
    idempotent); single-rank traces default to rank 0 so every trace is
    self-describing and mergeable."""
    global _rank, _role
    if rank is not None or role is not None:
        with _lock:
            if rank is not None:
                _rank = rank
            if role is not None:
                _role = role


# --------------------------------------------------------- causal context


def current_trace_id() -> Optional[str]:
    """The ambient trace id (None outside any take/restore root)."""
    return _TRACE_CTX.get()


def new_trace_id(kind: str) -> str:
    return f"{kind}-{uuid.uuid4().hex[:12]}"


@contextmanager
def trace_scope(kind: str, join: bool = False):
    """Stamp a fresh trace id for one take/restore root. Yields the id.
    Nested roots (a restore issued inside another operation) get their
    own id — the innermost root wins, which is what per-operation
    attribution wants. ``join=True`` keeps an enclosing scope of the
    same kind instead: a ``CheckpointManager`` call that opened the
    operation's scope around the snapshot's own root."""
    current = _TRACE_CTX.get()
    if join and current is not None and current.startswith(f"{kind}-"):
        yield current
        return
    token = _TRACE_CTX.set(new_trace_id(kind))
    try:
        yield _TRACE_CTX.get()
    finally:
        _TRACE_CTX.reset(token)


def current_span_id() -> Optional[int]:
    """The innermost open span's id in this context (None while tracing
    is off): capture it where work is handed to another thread and pass
    it to :func:`adopt_trace` there."""
    return _SPAN_CTX.get()


@contextmanager
def adopt_trace(trace_id: Optional[str], parent: Optional[int] = None):
    """Run a region under an INHERITED trace id (a snapserve server
    handling a request that carried context, a hot-tier drain persisting
    a take's bytes), its outermost spans the children of span ``parent``.
    No-op for None."""
    if trace_id is None and parent is None:
        yield
        return
    token = _TRACE_CTX.set(trace_id) if trace_id is not None else None
    span_token = _SPAN_CTX.set(parent) if parent is not None else None
    try:
        yield
    finally:
        if span_token is not None:
            _SPAN_CTX.reset(span_token)
        if token is not None:
            _TRACE_CTX.reset(token)


def carry(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn``, run under the caller's trace id and innermost span on
    whatever thread calls it: for work handed to an executor or a
    pipeline worker, whose threads carry no context. ``fn`` itself when
    there is nothing to carry."""
    trace, parent = _TRACE_CTX.get(), _SPAN_CTX.get()
    if trace is None and parent is None:
        return fn

    def _carried(*args: Any, **kwargs: Any) -> Any:
        with adopt_trace(trace, parent):
            return fn(*args, **kwargs)

    return _carried


def _new_flow_id() -> str:
    """Globally-unique flow id: trace-scoped when a trace is active so
    the id is meaningful even in a process that records no events."""
    base = _TRACE_CTX.get() or "anon"
    return f"{base}/{os.getpid()}.{next(_flow_seq)}"


def _flow_event(ph: str, name: str, flow_id: str, args: Dict[str, Any]) -> None:
    ev: Dict[str, Any] = {
        "name": name,
        "cat": "flow",
        "ph": ph,
        "id": flow_id,
        "ts": (time.monotonic() - _t0) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0xFFFFFFFF,
    }
    if ph == "f":
        ev["bp"] = "e"  # bind to enclosing slice (Perfetto convention)
    trace = _TRACE_CTX.get()
    if trace is not None:
        args = dict(args, trace=trace)
    if args:
        ev["args"] = args
    evs = _events
    if evs is not None:
        with _lock:
            evs.append(ev)


def flow_start(name: str, **args: Any) -> Optional[str]:
    """Open a cross-process flow (e.g. before sending an RPC). Returns
    the flow id to put on the wire — generated whenever a trace context
    is active OR this process records events (a tracing-off client still
    hands a tracing-on server something to bind to); None otherwise."""
    if _TRACE_CTX.get() is None and _events is None:
        return None
    flow_id = _new_flow_id()
    if _events is not None:
        _flow_event("s", name, flow_id, args)
    return flow_id


def flow_step(name: str, flow_id: Optional[str], **args: Any) -> None:
    """Record the remote half of a flow (the server handling a request
    whose frame carried ``flow_id``)."""
    if flow_id is None or _events is None:
        return
    _flow_event("t", name, flow_id, args)


def flow_end(name: str, flow_id: Optional[str], **args: Any) -> None:
    """Close a flow (the client observing the response)."""
    if flow_id is None or _events is None:
        return
    _flow_event("f", name, flow_id, args)


def _clock_pair() -> Tuple[float, float]:
    """(``time.monotonic()``, ``time.time()``) seconds of one instant: of
    a few wall reads each bracketed by two monotonic reads, the tightest
    bracketing, its monotonic midpoint beside its wall read."""
    reads = []
    for _ in range(_CLOCK_PAIR_READS):
        m0 = time.monotonic_ns()
        wall = time.time_ns()
        m1 = time.monotonic_ns()
        reads.append((m1 - m0, (m0 + m1) // 2, wall))
    _, mono, wall = min(reads)
    return mono / 1e9, wall / 1e9


def enable(path: str) -> None:
    """Start recording spans; ``flush()`` (or process exit) writes them."""
    global _events, _path, _t0, _wall0, _pid_at_enable
    mono, wall = _clock_pair()
    with _lock:
        _events = []
        _path = path
        _t0, _wall0 = mono, wall
        _pid_at_enable = os.getpid()


def disable() -> None:
    """Stop recording. Flushes first: a programmatic enable→span→disable
    sequence must not silently drop its spans (the previous behavior —
    callers had to know to call flush() themselves)."""
    global _events, _path
    flush()
    with _lock:
        _events = None
        _path = None


def enabled() -> bool:
    return _events is not None


def flush() -> Optional[str]:
    """Write accumulated events as Chrome trace JSON; returns the path.

    Crash-safe: the document lands in a ``.tmp<pid>`` sibling and is
    renamed into place, so a crash (or a concurrent reader — the
    summarize CLI tailing a live run) never sees a torn, unloadable
    trace where a previous flush's complete one existed.
    """
    with _lock:
        if _events is None or _path is None:
            return None
        path = _path
        if _pid_at_enable and os.getpid() != _pid_at_enable:
            # Forked child: the inherited path belongs to the PARENT.
            # Re-suffix with our own pid so the child's flush (atexit,
            # disable) can never clobber the parent's trace file —
            # the multi-process-merge prerequisite of distinct inputs.
            root, ext = os.path.splitext(path)
            path = f"{root}.pid{os.getpid()}{ext or '.json'}"
        payload = {
            "traceEvents": [e if isinstance(e, dict) else _span_event(e) for e in _events],
            "displayTimeUnit": "ms",
            # Self-describing clock + identity, even for single-rank
            # traces: the merge prerequisite. ``clock_epoch_s`` is the
            # wall-clock epoch of trace ts 0 (events carry monotonic µs
            # offsets from it), so N traces from N hosts can be aligned
            # onto one timeline and skew-corrected.
            "metadata": {
                "clock_epoch_s": _wall0,
                "rank": _rank if _rank is not None else 0,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "role": _role,
                "tracer": "torchsnapshot_tpu",
            },
        }
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    finally:
        # A failed dump (disk full, crash between write and rename on
        # this thread) must not leave .tmp debris next to the trace.
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            # Best-effort cleanup; the trace itself is intact either way.
            except OSError:  # snapcheck: disable=swallowed-exception -- tmp cleanup
                pass
    return path


@contextmanager
def span(name: str, **args: Any):
    """Time a region. ``args`` (small JSON-able values) land in the begin
    event; the region may add more to the dict it is given (None while
    tracing is off), which land in the end event.

    Emitted as an async begin/end pair with a unique id, so arbitrarily
    overlapping spans (concurrent scheduler IO on one event-loop thread)
    stay well-formed. The begin event's ``parent`` is the id of the
    innermost span open in this context.

    A span is recorded as a tuple and becomes its Chrome-trace event at
    flush: the restore's pipeline threads run spans by the thousand while
    holding the interpreter lock, so recording does as little as it can.
    """
    evs = _events
    if evs is None:
        yield None
        return
    span_id = next(_span_ids)
    parent = _SPAN_CTX.get()
    # list.append is atomic: recording takes no lock.
    evs.append(
        ("b", name, span_id, time.monotonic(), threading.get_ident(), os.getpid(), parent,
         args, _TRACE_CTX.get())
    )
    token = _SPAN_CTX.set(span_id)
    end_args: Dict[str, Any] = {}
    try:
        yield end_args
    finally:
        try:
            _SPAN_CTX.reset(token)
        except ValueError:  # closed from another context than it opened in
            _SPAN_CTX.set(parent)
        evs = _events
        if evs is not None:
            evs.append(
                ("e", name, span_id, time.monotonic(), threading.get_ident(), os.getpid(), end_args)
            )


def complete(name: str, start: float, end: float, **args: Any) -> None:
    """Record a span that has ended: ``start`` and ``end`` are the
    ``time.monotonic()`` readings that code timing itself took around it.
    Its parent is the innermost span open here. For per-piece code on the
    restore's hot threads, where a ``with span(...)`` costs several times
    as much; call it only while :func:`enabled`."""
    evs = _events
    if evs is None:
        return
    span_id = next(_span_ids)
    tid, pid = threading.get_ident(), os.getpid()
    evs.append(("b", name, span_id, start, tid, pid, _SPAN_CTX.get(), args, _TRACE_CTX.get()))
    evs.append(("e", name, span_id, end, tid, pid, None))


def _span_event(record: tuple) -> Dict[str, Any]:
    """The Chrome-trace event of one recorded span begin or end."""
    ph, name, span_id, t, tid, pid = record[:6]
    event: Dict[str, Any] = {
        "name": name,
        "cat": "snapshot",
        "ph": ph,
        "id": span_id,
        "ts": (t - _t0) * 1e6,
        "pid": pid,
        "tid": tid & 0xFFFFFFFF,
    }
    if ph == "b":
        parent, args, trace = record[6:]
        if parent is not None:
            event["parent"] = parent
        if trace is not None and "trace" not in args:
            # Causal attribution: every span under a take/restore root (or
            # an adopted remote/drain context) names its trace.
            args = dict(args, trace=trace)
    else:
        args = record[6]
    if args:
        event["args"] = args
    return event


def instant(name: str, **args: Any) -> None:
    """Record a zero-duration marker (e.g. "manifest committed")."""
    if _events is None:
        return
    trace = _TRACE_CTX.get()
    if trace is not None and "trace" not in args:
        args = dict(args, trace=trace)
    ev = {
        "name": name,
        "ph": "i",
        "s": "p",  # process-scoped instant
        "ts": (time.monotonic() - _t0) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0xFFFFFFFF,
    }
    if args:
        ev["args"] = args
    evs = _events
    if evs is not None:
        with _lock:
            evs.append(ev)


def derive_env_path(path: str, role: Optional[str]) -> str:
    """The per-process output path for an env-configured trace: role
    (when set) and pid suffixes keep every process's file distinct — a
    snapserve server subprocess launched with the SAME
    ``TPUSNAPSHOT_TRACE`` as its client must not clobber the client's
    trace, and the multi-process merge needs both files. Literal
    replace, not str.format — an env path with other braces must not
    crash import."""
    if "{role}" in path:
        path = path.replace("{role}", role or "rank")
        role = None  # placeholder consumed; no extra suffix
    if "{pid}" in path:
        return path.replace("{pid}", str(os.getpid()))
    root, ext = os.path.splitext(path)
    tag = f".{role}" if role else ""
    return f"{root}{tag}.pid{os.getpid()}{ext or '.json'}"


def _maybe_enable_from_env() -> None:
    path = os.environ.get(_TRACE_ENV_VAR)
    if not path:
        return
    role = os.environ.get(_TRACE_ROLE_ENV_VAR) or None
    if role is not None:
        set_identity(role=role)
    enable(derive_env_path(path, role))
    atexit.register(flush)


_maybe_enable_from_env()
