"""The program's own spans on the device trace's clock.

A traced run leaves two files in ``build/perfbench/``: the program's trace
(``<cell>.spans.json``, written by ``torchsnapshot_tpu_torch.tracing``) and
the profiler's Chrome trace (``<cell>.trace.json``). The program's events
carry microseconds from its tracer's start, whose wall-clock time is
``metadata.clock_epoch_s``; the profiler's carry microseconds from its
``baseTimeNanoseconds``. So an event of the program lies on the profiler's
timeline at

    profiler_us = clock_epoch_s * 1e6 + ts - baseTimeNanoseconds / 1e3

This module reads both files, puts the program's spans on that clock, and
names the card's idle gaps by what the program was doing:
``idle_gaps_program`` labels each gap by the innermost span open on the
training thread at its midpoint (``outside_program`` where none is) and by
the innermost spans open on the program's other threads, as
``"<training>|<other>,<other>"``.

Run after a traced run, from the checkout's root::

    python3 perfbench/program_trace.py <cell> [--top 40]

It prints one JSON object: the longest gaps so named, the idle seconds by
training-thread label, the share of the idle inside the benchmark's
``perfbench.restore`` annotations that a span below
``CheckpointManager.restore`` names, and how the program's root spans sit
inside the benchmark's own annotations around the same calls (each should
lie inside; a negative slack is a clock error).

Everything here reads files only, and returns None or nothing where a file,
a clock key or a span is missing: a program without these spans reads as
nothing, never as an error.
"""

import json
import re
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

if __package__ in (None, ""):  # run as a script
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import tracer  # noqa: E402

OUTSIDE = "outside_program"
# The calls through which the program holds the training loop.
LIBRARY_ROOTS = ("Snapshot.async_take", "CheckpointManager.wait", "CheckpointManager.restore")
RESTORE_ROOT = "CheckpointManager.restore"
# Each program root and the benchmark annotation around its call.
ANNOTATED_ROOTS = {"Snapshot.async_take": "perfbench.async_save",
                   "CheckpointManager.wait": "perfbench.wait_prev",
                   "CheckpointManager.restore": "perfbench.restore"}
# torch.profiler writes baseTimeNanoseconds before the events.
_HEAD_BYTES = 1 << 16
_BASE_RE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def base_time_ns(trace_path: Path) -> Optional[int]:
    """``baseTimeNanoseconds`` of a profiler Chrome trace, read from its
    head (else its tail) rather than parsing the whole file."""
    try:
        with open(trace_path, "rb") as f:
            found = _BASE_RE.search(f.read(_HEAD_BYTES))
            if found is None:
                f.seek(0, 2)
                f.seek(max(0, f.tell() - _HEAD_BYTES))
                found = _BASE_RE.search(f.read())
    except OSError:
        return None
    return int(found.group(1)) if found is not None else None


def read_spans(spans_path: Path) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The program's begin/end pairs as ``{name, id, parent, tid, t0, t1,
    args}`` (seconds from its tracer's start; ``args`` of the begin and the
    end merged), in begin order, and the trace's metadata."""
    with open(spans_path) as f:
        doc = json.load(f)
    open_: Dict[Any, Dict[str, Any]] = {}
    spans: List[Dict[str, Any]] = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "b":
            entry = {"name": e.get("name"), "id": e.get("id"), "parent": e.get("parent"),
                     "tid": e.get("tid"), "t0": e["ts"] / 1e6, "t1": None,
                     "args": dict(e.get("args") or {})}
            open_[(e.get("name"), e.get("id"))] = entry
            spans.append(entry)
        elif e.get("ph") == "e":
            entry = open_.pop((e.get("name"), e.get("id")), None)
            if entry is not None:
                entry["t1"] = e["ts"] / 1e6
                entry["args"].update(e.get("args") or {})
    return [s for s in spans if s["t1"] is not None], dict(doc.get("metadata") or {})


def to_profiler_us(spans: Iterable[Dict[str, Any]], clock_epoch_s: float,
                   base_ns: int) -> List[Dict[str, Any]]:
    """Each span with ``a``/``b``: its ends on the profiler's clock (us)."""
    offset = clock_epoch_s * 1e6 - base_ns / 1e3
    return [dict(s, a=offset + s["t0"] * 1e6, b=offset + s["t1"] * 1e6) for s in spans]


class ProgramTrace:
    """A run's program spans on the profiler's clock."""

    def __init__(self, spans: List[Dict[str, Any]]) -> None:
        self.spans = spans
        self.training_tid = training_tid(spans)
        self._by_tid: Dict[Any, List[Dict[str, Any]]] = {}
        for s in sorted(spans, key=lambda s: s["a"]):
            self._by_tid.setdefault(s["tid"], []).append(s)

    def named(self, names: Sequence[str], tid: Any = None) -> List[Dict[str, Any]]:
        return [s for s in self.spans if s["name"] in names and (tid is None or s["tid"] == tid)]

    def labels(self, times: Sequence[float]) -> List[Tuple[str, str]]:
        """For each time (profiler us): the innermost span open on the
        training thread, or ``outside_program``, and the innermost spans
        open on the other threads, joined by commas. The innermost span of
        a thread is the one open there that began last (of those, the
        shortest)."""
        order = sorted(range(len(times)), key=lambda i: times[i])
        out: List[Tuple[str, str]] = [(OUTSIDE, "")] * len(times)
        nexts = {tid: 0 for tid in self._by_tid}
        active: Dict[Any, List[Dict[str, Any]]] = {tid: [] for tid in self._by_tid}
        for i in order:
            t = times[i]
            inner: Dict[Any, Dict[str, Any]] = {}
            for tid, spans in self._by_tid.items():
                k = nexts[tid]
                while k < len(spans) and spans[k]["a"] <= t:
                    active[tid].append(spans[k])
                    k += 1
                nexts[tid] = k
                live = active[tid] = [s for s in active[tid] if s["b"] >= t]
                if live:
                    inner[tid] = max(live, key=lambda s: (s["a"], s["a"] - s["b"]))
            training = inner.pop(self.training_tid, None)
            out[i] = (training["name"] if training is not None else OUTSIDE,
                      ",".join(sorted({s["name"] for s in inner.values()})))
        return out


def training_tid(spans: Iterable[Dict[str, Any]]) -> Any:
    """The thread that calls the program: the one with the most seconds in
    its root calls."""
    seconds: Dict[Any, float] = {}
    for s in spans:
        if s["name"] in LIBRARY_ROOTS:
            seconds[s["tid"]] = seconds.get(s["tid"], 0.0) + s["t1"] - s["t0"]
    return max(seconds, key=seconds.get) if seconds else None


def load(spans_path: Path, trace_path: Path) -> Optional[ProgramTrace]:
    """Both files of a run as a :class:`ProgramTrace`; None when either
    is missing or lacks its clock."""
    base = base_time_ns(trace_path)
    if base is None or not spans_path.exists():
        return None
    spans, metadata = read_spans(spans_path)
    epoch = metadata.get("clock_epoch_s")
    if epoch is None:
        return None
    return ProgramTrace(to_profiler_us(spans, float(epoch), base))


_CACHE: Dict[Tuple[str, float, int], Optional[ProgramTrace]] = {}


def for_context(ctx: Any, out_dir: Optional[Path] = None) -> Optional[ProgramTrace]:
    """This run's program trace: the newest ``*.spans.json`` of the run's
    output directory whose spans are the context's, beside its profiler
    trace. None when no file matches."""
    if not ctx.port_spans:
        return None
    if out_dir is None:
        from perfbench import harness

        out_dir = harness.OUT_DIR
    try:
        candidates = sorted(Path(out_dir).glob("*.spans.json"), key=lambda p: -p.stat().st_mtime)
    except OSError:
        return None
    first, last = ctx.port_spans[0], ctx.port_spans[-1]
    for path in candidates:
        try:
            spans = tracer.read_port_spans(path)
        except (OSError, ValueError):
            continue
        if len(spans) != len(ctx.port_spans) or (spans[0]["name"], spans[0]["t0"]) != (
                first["name"], first["t0"]) or (spans[-1]["name"], spans[-1]["t0"]) != (
                last["name"], last["t0"]):
            continue
        stat = path.stat()
        key = (str(path), stat.st_mtime, stat.st_size)
        if key not in _CACHE:
            trace_path = path.with_name(path.name[: -len(".spans.json")] + ".trace.json")
            _CACHE.clear()
            _CACHE[key] = load(path, trace_path)
        return _CACHE[key]
    return None


def idle_intervals(events: List[Dict[str, Any]], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The stretches of ``window`` with no device event, in time order."""
    gaps = []
    reach = window[0]
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["ts"] > reach:
            gaps.append((reach, e["ts"]))
        reach = max(reach, e["ts"] + e["dur"])
    if window[1] > reach:
        gaps.append((reach, window[1]))
    return gaps


def intersect(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The overlaps of two lists of intervals (each in any order)."""
    out = []
    for x0, x1 in a:
        for y0, y1 in b:
            lo, hi = max(x0, y0), min(x1, y1)
            if hi > lo:
                out.append((lo, hi))
    return out


def gaps_in_window(ctx: Any) -> Optional[List[Tuple[float, float]]]:
    window = ctx.traced_window_us()
    if window is None:
        return None
    return idle_intervals(ctx.device_in_window(), window)


def idle_gaps_program(ctx: Any, program: ProgramTrace, top: int = 10) -> Optional[List[List[Any]]]:
    """The ``top`` longest idle gaps of the traced window as
    ``[label, seconds]``, each labelled at its midpoint."""
    gaps = gaps_in_window(ctx)
    if gaps is None:
        return None
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    labels = program.labels([(a + b) / 2 for a, b in gaps])
    return [["|".join(label), (b - a) / 1e6] for label, (a, b) in zip(labels, gaps)]


def idle_by_training_label(ctx: Any, program: ProgramTrace) -> Dict[str, float]:
    """Idle seconds of the traced window by the training thread's label,
    each gap labelled at its midpoint."""
    out: Dict[str, float] = {}
    gaps = gaps_in_window(ctx) or []
    for (name, _), (a, b) in zip(program.labels([(a + b) / 2 for a, b in gaps]), gaps):
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def restore_idle_named(ctx: Any, program: ProgramTrace) -> Optional[Dict[str, float]]:
    """Of the idle inside the benchmark's ``perfbench.restore`` annotations,
    the seconds, and the seconds whose training-thread label lies below
    ``CheckpointManager.restore`` (neither the root itself nor
    ``outside_program``), each piece labelled at its midpoint."""
    restores = [(n["ts"], n["ts"] + n["dur"]) for n in ctx.annotations
                if n["name"] == tracer.ANNOTATION_PREFIX + "restore"]
    gaps = gaps_in_window(ctx)
    if not restores or gaps is None:
        return None
    total = below = 0.0
    pieces = intersect(gaps, restores)
    for (name, _), (a, b) in zip(program.labels([(a + b) / 2 for a, b in pieces]), pieces):
        total += (b - a) / 1e6
        if name not in (RESTORE_ROOT, OUTSIDE):
            below += (b - a) / 1e6
    return {"idle_s": total, "named_below_root_s": below,
            "share": below / total if total > 0 else None}


def root_slack_us(ctx: Any, program: ProgramTrace) -> Dict[str, List[float]]:
    """For each program root inside the benchmark's annotation of the same
    call: the least slack at its start and at its end (us). A mapped clock
    that is right keeps both at or above zero."""
    out: Dict[str, List[float]] = {}
    for root, note in ANNOTATED_ROOTS.items():
        notes = [n for n in ctx.annotations if n["name"] == note]
        starts, ends = [], []
        for s in program.named((root,), program.training_tid):
            around = [n for n in notes if n["ts"] - 5e3 <= s["a"] and s["b"] <= n["ts"] + n["dur"] + 5e3]
            if around:
                n = min(around, key=lambda n: abs(n["ts"] - s["a"]))
                starts.append(s["a"] - n["ts"])
                ends.append(n["ts"] + n["dur"] - s["b"])
        if starts:
            out[root] = [min(starts), min(ends), len(starts)]
    return out


def library_idle_seconds(ctx: Any, program: ProgramTrace) -> Optional[Tuple[float, float]]:
    """(idle seconds of the traced window while the training thread is
    inside one of the program's root calls, the window's seconds); None
    when the program has no root span."""
    window = ctx.traced_window_us()
    roots = program.named(LIBRARY_ROOTS, program.training_tid)
    if window is None or not roots:
        return None
    held = intersect([(s["a"], s["b"]) for s in roots], [window])
    idle = intersect(idle_intervals(ctx.device_in_window(), window), held)
    return tracer.union_seconds(idle) / 1e6, (window[1] - window[0]) / 1e6


def context_from_files(spans_path: Path, trace_path: Path) -> Any:
    """A ``tracer.Context`` with the device events and annotations of a
    profiler trace and the program's spans, for reading outside a run."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    device, notes = tracer.split_device_events(events)
    return tracer.Context(job=None, window={}, spans=[], drains=[],
                          port_spans=tracer.read_port_spans(spans_path),
                          device_events=device, annotations=notes)


def main(argv: List[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="perfbench/program_trace.py")
    parser.add_argument("cell")
    parser.add_argument("--dir", default=str(Path(__file__).resolve().parent.parent / "build" / "perfbench"))
    parser.add_argument("--top", type=int, default=40)
    args = parser.parse_args(argv)
    spans_path = Path(args.dir) / f"{args.cell}.spans.json"
    trace_path = Path(args.dir) / f"{args.cell}.trace.json"
    if not spans_path.exists() or not trace_path.exists():
        print(f"no traced run of {args.cell} in {args.dir}", file=sys.stderr)
        return 2
    program = load(spans_path, trace_path)
    if program is None:
        print("the traces lack a clock to map the program's spans", file=sys.stderr)
        return 2
    ctx = context_from_files(spans_path, trace_path)
    held = library_idle_seconds(ctx, program)
    counts: Dict[str, int] = {}
    for s in program.spans:
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    found = tracer.busy_and_window(ctx)
    print(json.dumps({
        "cell": args.cell,
        "spans": len(program.spans),
        "spans_bytes": spans_path.stat().st_size,
        "span_counts": dict(sorted(counts.items(), key=lambda kv: -kv[1])),
        "busy_s_window_s": list(found) if found else None,
        "library_idle_s_window_s": list(held) if held else None,
        "root_slack_us": root_slack_us(ctx, program),
        "restore_idle_named": restore_idle_named(ctx, program),
        "idle_by_training_label": idle_by_training_label(ctx, program),
        "idle_gaps_program": idle_gaps_program(ctx, program, args.top),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
