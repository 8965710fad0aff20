"""``async_save``: each cycle waits on the previous save, as a training loop
does before it starts the next, then calls ``CheckpointManager.async_save``;
the drain overlaps the cycle's steps.

Checked: the window's last save, restored after the window, holds bit for
bit the state and the step it captured (``snapshot_leaves_differ``).
"""

import threading
import time
from typing import Any, Dict, List, Optional

from perfbench import checks


class DrainWatch:
    """Notes when an async save's drain thread has ended, that is, when its
    snapshot committed (``done()``). A thread of its own waits in
    ``join()``, which holds no GIL while the drain runs; used by traced runs
    only."""

    def __init__(self, pending: Any, returned: float) -> None:
        self.returned = returned
        self.done_at: Optional[float] = None
        drain = getattr(getattr(getattr(pending, "_pending", None), "_background", None), "thread", None)
        self._thread: Optional[threading.Thread] = None
        if isinstance(drain, threading.Thread):
            self._thread = threading.Thread(target=self._wait, args=(drain,),
                                            name="perfbench-drain-watch", daemon=True)
            self._thread.start()

    def _wait(self, drain: threading.Thread) -> None:
        drain.join()
        self.done_at = time.monotonic()

    def close(self) -> None:
        """After the save was waited: the watch notes the end and stops."""
        if self._thread is not None:
            self._thread.join(timeout=10)


class Operation:
    def __init__(self, window: Any, call: Dict[str, Any]) -> None:
        self.window, self.call = window, call
        self.pending: Any = None
        self.captured: Optional[Dict[str, Any]] = None
        self.drains: List[DrainWatch] = []

    def _save(self) -> Any:
        job = self.window.job
        return self.window.manager.async_save(job.progress["step"], job.app_state, **self.call)

    def prepare(self) -> None:
        self._save().wait()
        checks.digests(self.window.job.state_tensors()[:1])  # the digest's weights, built here

    def run(self, cycle: int, last: bool) -> None:
        w = self.window
        if self.pending is not None:
            with w.rec.span("wait_prev", cycle=cycle):
                self.pending.wait()
        if last:
            with w.check(cycle):
                self.captured = {"step": w.job.progress["step"],
                                 "digests": checks.digests(w.job.state_tensors())}
        with w.rec.span("async_save", cycle=cycle):
            self.pending = self._save()
        if w.watch_drains:
            self.drains.append(DrainWatch(self.pending, time.monotonic()))

    def finish(self) -> Dict[str, int]:
        """The wait on the last save, whose drain overlapped the last
        cycle's steps, and a restore of it: how many leaves (and the step)
        differ from the state it captured."""
        job = self.window.job
        self.pending.wait()
        for watch in self.drains:
            watch.close()
        if self.captured is None:  # no save was captured: every leaf counts as differing
            return {"snapshot_leaves_differ": len(job.state_tensors()) + 1}
        restored_step = self.window.manager.restore(job.app_state)
        now = checks.digests(job.state_tensors())
        misses = sum(a != b for a, b in zip(now, self.captured["digests"]))
        misses += int(restored_step != self.captured["step"]) + int(job.progress["step"] != self.captured["step"])
        return {"snapshot_leaves_differ": misses}
