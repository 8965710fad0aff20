"""The traced run's sources, and what the per-layer metric readers get.

- the device trace: ``torch.profiler`` (CPU and CUDA activities) over the
  last whole cycles of the window, exported as a Chrome trace into the
  checkout's ``build/perfbench/`` and read back: kernels, copies and sets on
  the card, and the benchmark's own ``perfbench.<name>`` annotations on the
  same clock;
- the program's spans: ``torchsnapshot_tpu_torch.tracing`` over the window
  (``stage``, ``write``, ``read``, ``consume`` with their take's trace id);
- the program's counters: each restore's ``_last_restore_report``;
- the benchmark's host-clock spans (``cycles.Recorder``).
"""

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_PREFIX = "perfbench."


class Profiler:
    """``torch.profiler`` over CPU and CUDA, started once and stopped once."""

    def __init__(self, cuda: bool = True) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=activities)
        self.running = False

    def start(self) -> None:
        self._prof.start()
        self.running = True

    def stop(self) -> None:
        if self.running:
            self._prof.stop()
            self.running = False

    def export(self, path: Path) -> List[Dict[str, Any]]:
        """Write the trace and read back its complete events."""
        path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        return [e for e in events if e.get("ph") == "X" and "dur" in e]


def read_port_spans(path: Path) -> List[Dict[str, Any]]:
    """The program's async begin/end span pairs as ``{name, t0, t1, args}``
    (seconds from the tracer's start)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    open_: Dict[Any, Dict[str, Any]] = {}
    spans = []
    for e in events:
        if e.get("ph") == "b":
            open_[(e.get("name"), e.get("id"))] = e
        elif e.get("ph") == "e":
            begin = open_.pop((e.get("name"), e.get("id")), None)
            if begin is not None:
                spans.append({"name": begin["name"], "t0": begin["ts"] / 1e6, "t1": e["ts"] / 1e6,
                              "args": begin.get("args", {})})
    return spans


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


@dataclass
class Context:
    """Everything a per-layer metric reader may read. Times of ``spans`` and
    ``drains`` are host seconds (``time.monotonic``); of ``device_events``
    and ``annotations``, the profiler's microseconds."""

    job: Any
    window: Dict[str, Any]
    spans: List[Dict[str, Any]]
    drains: List[Tuple[float, Optional[float]]]
    port_spans: List[Dict[str, Any]] = field(default_factory=list)
    restore_reports: List[Any] = field(default_factory=list)
    device_events: List[Dict[str, Any]] = field(default_factory=list)
    annotations: List[Dict[str, Any]] = field(default_factory=list)

    def named(self, name: str) -> List[Dict[str, Any]]:
        return [s for s in self.spans if s["name"] == name]

    def traced_window_us(self) -> Optional[Tuple[float, float]]:
        """First to last profiled cycle, on the profiler's clock."""
        cycles = [a for a in self.annotations if a["name"] == ANNOTATION_PREFIX + "cycle"]
        if not cycles:
            return None
        return min(a["ts"] for a in cycles), max(a["ts"] + a["dur"] for a in cycles)

    def device_in_window(self, categories=DEVICE_CATEGORIES) -> List[Dict[str, Any]]:
        """Device events inside the traced window, clipped to it."""
        window = self.traced_window_us()
        if window is None:
            return []
        lo, hi = window
        out = []
        for e in self.device_events:
            if e.get("cat") not in categories:
                continue
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                out.append(dict(e, ts=a, dur=b - a))
        return out


def split_device_events(events: List[Dict[str, Any]]) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(device events, the benchmark's annotations) of an exported trace."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    notes = [e for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(ANNOTATION_PREFIX)]
    return device, notes


def busy_and_window(ctx: Context) -> Optional[Tuple[float, float]]:
    """(seconds with a kernel, copy or set on the card, seconds of the
    traced window)."""
    window = ctx.traced_window_us()
    if window is None:
        return None
    busy = union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in ctx.device_in_window()])
    return busy / 1e6, (window[1] - window[0]) / 1e6


def breakdown(ctx: Context, top: int = 10) -> Optional[Dict[str, Any]]:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost benchmark annotation around each (the host's
    work at the time)."""
    events = ctx.device_in_window()
    window = ctx.traced_window_us()
    if not events or window is None:
        return None
    by_name: Dict[str, float] = {}
    for e in events:
        name = str(e.get("name"))[:160]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    reach = window[0]
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["ts"] > reach:
            gaps.append((reach, e["ts"]))
        reach = max(reach, e["ts"] + e["dur"])
    if window[1] > reach:
        gaps.append((reach, window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        around = [n for n in ctx.annotations if n["ts"] <= mid <= n["ts"] + n["dur"]]
        label = min(around, key=lambda n: n["dur"])["name"] if around else "outside_annotations"
        named.append([label, (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
