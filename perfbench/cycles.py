"""The one general generator: a traffic mix, read from its data file, run as
cycles of one checkpoint operation and then training steps.

A mix's file (``perfbench/traffic/<mix>.json``) gives:

- ``operation``: the name of the module ``perfbench/operations/<name>.py``
  that opens each cycle (``async_save``, ``restore``); a new kind of cycle
  is a new module;
- ``steps_per_cycle``: training steps after each operation;
- ``storage``: where the manager keeps its snapshots, ``"memory"`` (the
  port's ``memory://`` object store, in this process), ``"fs"`` (a
  directory under the run's ``TMPDIR``, removed after the run) or ``"shm"``
  (the port's fs plugin over a fresh directory under ``/dev/shm``, which
  must be tmpfs: a store in RAM that the ranks of a cell share; removed
  after the run);
- ``manager``: keyword arguments of ``CheckpointManager`` (``max_to_keep``,
  ``incremental``, ``chunks``, ``codec``, ...), passed on as they are;
- ``call``: keyword arguments of the operation's call on the manager
  (``stage`` and ``compression`` of ``async_save``, ``paths`` of
  ``restore``), passed on as they are;
- ``trace_cycles``: how many whole cycles a ``--trace 1`` run profiles, the
  last ones of the window;
- ``layout`` (optional): how the job is laid out over a cell's cards, a
  rank per card: the family module is ``<config's family>_<layout>``
  (``"fsdp"``: ``perfbench/families/transformer_fsdp.py``). A cell of more
  than one chip needs one; a cell of one chip has none;
- ``limits`` (optional): limits of ``correct`` that this cell's readings
  set apart from its configuration's, by check name.

The window holds whole cycles only, about ``--seconds`` of them: the last
is the one after which a cycle of the longest length seen so far would end
past it; with a rank per card, rank 0 decides this and the others follow
(``perfbench/ranks.py``). The benchmark's own checks inside a cycle (the
``digest`` spans) are left out of the window's seconds. Every step ends by reading its loss
on the host, as a training loop that logs its loss does.
"""

import importlib
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

STORAGES = ("memory", "fs", "shm")
# Spans of the benchmark's own checks: excluded from the window's seconds.
CHECK_SPAN = "digest"


def operation(name: str) -> Any:
    """``perfbench/operations/<name>.py``; an unknown name raises."""
    module = importlib.import_module(f"perfbench.operations.{name}")
    if not isinstance(getattr(module, "Operation", None), type):
        raise TypeError(f"perfbench/operations/{name}.py has no Operation class")
    return module


def validate(traffic: Dict[str, Any]) -> None:
    operation(traffic.get("operation", ""))
    if int(traffic["steps_per_cycle"]) < 1 or int(traffic["trace_cycles"]) < 1:
        raise ValueError("steps_per_cycle and trace_cycles must be at least 1")
    if traffic.get("storage") not in STORAGES:
        raise ValueError(f"traffic storage {traffic.get('storage')!r} is not one of {STORAGES}")
    for key in ("manager", "call"):
        if not isinstance(traffic.get(key), dict):
            raise ValueError(f"traffic {key!r} must be an object of keyword arguments")
    if "layout" in traffic and not str(traffic["layout"]).isidentifier():
        raise ValueError(f"traffic layout {traffic['layout']!r} is not a module name")
    if not all(isinstance(v, (int, float)) for v in traffic.get("limits", {}).values()):
        raise ValueError("traffic limits must map a check's name to a number")


class Recorder:
    """Host-clock spans of the benchmark's own calls (``time.monotonic``),
    mirrored into the profiler as ``perfbench.<name>`` annotations when a
    run is traced."""

    def __init__(self, annotate: bool) -> None:
        self.annotate = annotate
        self.spans: List[Dict[str, Any]] = []

    @contextmanager
    def span(self, name: str, **attrs: Any):
        marker = torch.profiler.record_function(f"perfbench.{name}") if self.annotate else nullcontext()
        entry = dict(attrs, name=name, t0=time.monotonic())
        with marker:
            yield
        entry["t1"] = time.monotonic()
        self.spans.append(entry)


class Window:
    """Runs the cycles of one mix on one job and keeps what the metrics and
    the checks read. The mix's operation reaches the job, the manager and
    the recorder through it."""

    def __init__(self, job: Any, manager: Any, traffic: Dict[str, Any], rec: Recorder,
                 watch_drains: bool, profiler: Optional[Any],
                 lockstep: Optional[Callable[[int, bool, bool], Tuple[bool, bool]]] = None) -> None:
        self.job, self.manager, self.traffic, self.rec = job, manager, traffic, rec
        self.watch_drains = watch_drains
        self.profiler = profiler
        # With a rank per card: (cycle, last, start the profiler) -> rank 0's
        # (last, start the profiler), the same on every rank.
        self.lockstep = lockstep
        self.profiled_cycles: List[int] = []
        self.losses: List[float] = []
        self.op = operation(traffic["operation"]).Operation(self, dict(traffic["call"]))

    def step(self, cycle: int) -> None:
        with self.rec.span("step", cycle=cycle):
            self.losses.append(float(self.job.step()))

    def prepare(self) -> None:
        """Set-up's checkpoint work, as the operation needs it."""
        self.op.prepare()

    @contextmanager
    def check(self, cycle: int):
        """A check of the benchmark's own inside the window: the device's
        queue is drained first (counted), the check itself is not."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with self.rec.span(CHECK_SPAN, cycle=cycle):
            yield

    def run(self, seconds: float) -> Dict[str, Any]:
        """The measured window: whole cycles from the first's start to the
        last's end, less the benchmark's checks. Whether a cycle is the last
        is decided as it starts: it is when a second cycle of the longest
        length seen so far would end past ``seconds``; with ``lockstep``,
        rank 0's decision holds on every rank."""
        k = int(self.traffic["steps_per_cycle"])
        trace_cycles = int(self.traffic["trace_cycles"])
        start = time.monotonic()
        deadline = start + seconds
        longest = 0.0
        cycle = 0
        last = False
        while not last:
            begin = time.monotonic()
            last = cycle > 0 and begin + 2 * longest > deadline
            profile = (self.profiler is not None and not self.profiled_cycles and cycle > 0
                       and (last or begin + (trace_cycles + 1) * longest > deadline))
            if self.lockstep is not None:
                last, profile = self.lockstep(cycle, last, profile)
            if profile and self.profiler is not None:
                self.profiler.start()
            if self.profiler is not None and (self.profiled_cycles or self.profiler.running):
                self.profiled_cycles.append(cycle)
            with self.rec.span("cycle", cycle=cycle):
                self.op.run(cycle, last)
                for _ in range(k):
                    self.step(cycle)
            longest = max(longest, time.monotonic() - begin)
            cycle += 1
        end = time.monotonic()
        checks_s = sum(s["t1"] - s["t0"] for s in self.rec.spans
                       if s["name"] == CHECK_SPAN and start <= s["t0"] < end)
        return {"window_s": end - start - checks_s, "checks_s": checks_s, "steps": cycle * k,
                "ops": cycle, "start": start, "end": end}

    def finish(self) -> Dict[str, int]:
        """After the window: the operation's exact comparisons, each a count
        whose limit is 0."""
        return self.op.finish()
