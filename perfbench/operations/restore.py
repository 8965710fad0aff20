"""``restore``: each cycle rolls the job back, as a preempted or diverged
job does, with ``CheckpointManager.restore`` of the snapshot taken in
set-up.

Checked: after every restore, the warm-up one of set-up included, the state
and the step are the snapshot's, bit for bit (``restore_leaves_differ``).
"""

from typing import Any, Dict, List, Optional

from perfbench import checks


class Operation:
    def __init__(self, window: Any, call: Dict[str, Any]) -> None:
        self.window, self.call = window, call
        self.rollback: Optional[Dict[str, Any]] = None
        self.misses: List[int] = []
        self.restore_reports: List[Any] = []

    def prepare(self) -> None:
        job = self.window.job
        step = job.progress["step"]
        self.window.manager.save(step, job.app_state)
        self.rollback = {"step": step, "digests": checks.digests(job.state_tensors())}
        self.window.manager.restore(job.app_state, **self.call)
        self._compare()

    def _compare(self) -> None:
        job = self.window.job
        now = checks.digests(job.state_tensors())
        misses = sum(a != b for a, b in zip(now, self.rollback["digests"]))
        self.misses.append(misses + int(job.progress["step"] != self.rollback["step"]))

    def run(self, cycle: int, last: bool) -> None:
        from torchsnapshot_tpu_torch import snapshot

        w = self.window
        with w.rec.span("restore", cycle=cycle):
            w.manager.restore(w.job.app_state, **self.call)
        self.restore_reports.append(snapshot._last_restore_report)
        with w.check(cycle):
            self._compare()

    def finish(self) -> Dict[str, int]:
        return {"restore_leaves_differ": sum(self.misses)}
