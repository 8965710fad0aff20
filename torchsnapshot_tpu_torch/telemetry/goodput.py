"""Goodput accountant: train vs checkpoint wall-time attribution.

The paper's differentiators (parallel persistence, elasticity) only pay
off while checkpointing stays a small, stable fraction of training
time — but nothing in the process knew that fraction. This module is
the tiny train-loop hook that makes it a first-class number:

    from torchsnapshot_tpu_torch.telemetry import goodput

    for step in range(n_steps):
        train_step(...)
        goodput.step()            # once per training step, that's all
        if step % 100 == 0:
            mgr.async_save(step, app_state)

``goodput.step()`` marks a step boundary; wall time between boundaries
is attributed to **train**, minus whatever the snapshot library spent
blocking the caller in the same window. The library reports its own
blocking time through :func:`blocked` (no user code needed):

- ``sync_take`` — the whole of ``Snapshot.take``;
- ``async_stall`` — ``Snapshot.async_take``'s foreground (the
  consistent-cut capture before it returns);
- ``drain_wait`` — ``PendingSnapshot.wait`` while the background drain
  is still running (the "checkpoint not done yet" stall);
- ``restore`` — ``Snapshot.restore``.

Exports, refreshed on every boundary/blocked exit:

- metrics: ``tpusnapshot_goodput_train_seconds_total``,
  ``tpusnapshot_goodput_checkpoint_seconds_total{mode=...}``, and the
  ``tpusnapshot_goodput_fraction`` gauge;
- the flight report: each rank summary carries a ``goodput`` dict once
  the accountant has data (see report.py);
- the telemetry ledger: every committed take's digest records the
  fraction at commit time, so ``timeline`` can trend it across a run.

The doctor's ``checkpoint-overhead-above-budget`` rule compares the
recorded overhead against ``TPUSNAPSHOT_CKPT_BUDGET_PCT`` (default 5).

Thread-safety: ``blocked`` runs on whatever thread performs the wait
(the foreground for take/wait); ``step()`` runs on the train loop.
All state is guarded by one lock; nesting of ``blocked`` on a thread
attributes only the outermost interval (``CheckpointManager.save``
wrapping ``Snapshot.take`` must not double-count).
"""

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

from . import metrics as _m
from .metrics import REGISTRY


class GoodputAccountant:
    """Wall-time attribution between train steps and checkpoint waits."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t_last_step: Optional[float] = None
        self._train_s = 0.0
        self._ckpt_by_mode: Dict[str, float] = {}
        # Checkpoint seconds accumulated since the last step() boundary,
        # subtracted from that window's train attribution.
        self._ckpt_since_step = 0.0
        self._steps = 0
        # Outermost blocked intervals currently open, by thread id:
        # snapshot() folds their elapsed time in, so a report built
        # INSIDE a take's own blocked window (the commit path) already
        # carries this take's blocking.
        self._active: Dict[int, Any] = {}

    # ------------------------------------------------------------- hooks

    def step(self) -> None:
        """Mark a train-step boundary (call once per training step)."""
        now = time.monotonic()
        with self._lock:
            if self._t_last_step is not None:
                window = now - self._t_last_step
                train = max(0.0, window - self._ckpt_since_step)
                self._train_s += train
                REGISTRY.counter(_m.GOODPUT_TRAIN_SECONDS).inc(train)
            self._t_last_step = now
            self._ckpt_since_step = 0.0
            self._steps += 1
        self._export_fraction()

    @contextmanager
    def blocked(self, mode: str) -> Iterator[None]:
        """Attribute the enclosed wall time to checkpoint ``mode``
        (``sync_take`` / ``async_stall`` / ``drain_wait`` / ``restore``).
        Re-entrant per thread: only the outermost interval counts."""
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        tid = threading.get_ident()
        t0 = time.monotonic()
        if depth == 0:
            with self._lock:
                self._active[tid] = (mode, t0)
        try:
            yield
        finally:
            self._tls.depth = depth
            if depth == 0:
                dt = time.monotonic() - t0
                with self._lock:
                    self._active.pop(tid, None)
                    self._ckpt_by_mode[mode] = (
                        self._ckpt_by_mode.get(mode, 0.0) + dt
                    )
                    self._ckpt_since_step += dt
                REGISTRY.counter(
                    _m.GOODPUT_CHECKPOINT_SECONDS, mode=mode
                ).inc(dt)
                self._export_fraction()

    def account(self, mode: str, seconds: float) -> None:
        """Directly attribute ``seconds`` to checkpoint ``mode`` (for
        callers that already timed the interval themselves)."""
        if seconds <= 0:
            return
        with self._lock:
            self._ckpt_by_mode[mode] = (
                self._ckpt_by_mode.get(mode, 0.0) + seconds
            )
            self._ckpt_since_step += seconds
        REGISTRY.counter(_m.GOODPUT_CHECKPOINT_SECONDS, mode=mode).inc(
            seconds
        )
        self._export_fraction()

    # ----------------------------------------------------------- reading

    def has_data(self) -> bool:
        with self._lock:
            return (
                self._steps > 0
                or bool(self._ckpt_by_mode)
                or bool(self._active)
            )

    def snapshot(self) -> Dict[str, Any]:
        """The attribution as plain data, including the elapsed portion
        of any still-open blocked interval (a take's flight summary is
        built inside its own blocked window). ``goodput_fraction`` is
        train/(train+checkpoint), None until any train time accrued
        (a bare take with no step() hooks has no denominator)."""
        now = time.monotonic()
        with self._lock:
            by_mode = dict(self._ckpt_by_mode)
            for mode, t0 in self._active.values():
                by_mode[mode] = by_mode.get(mode, 0.0) + (now - t0)
            ckpt_s = sum(by_mode.values())
            total = self._train_s + ckpt_s
            # Without step() boundaries there is no train denominator:
            # a bare take would read as "100% overhead", which is
            # noise, not a verdict — fraction/overhead stay None.
            fraction = (
                self._train_s / total
                if total > 0 and self._steps > 0
                else None
            )
            return {
                "train_s": round(self._train_s, 6),
                "checkpoint_s": round(ckpt_s, 6),
                "by_mode": {
                    m: round(v, 6) for m, v in sorted(by_mode.items())
                },
                "steps": self._steps,
                "goodput_fraction": (
                    round(fraction, 6) if fraction is not None else None
                ),
                "checkpoint_overhead_pct": (
                    round(100.0 * (1.0 - fraction), 3)
                    if fraction is not None
                    else None
                ),
            }

    def reset(self) -> None:
        """Drop all attribution (tests; never called by library code)."""
        with self._lock:
            self._t_last_step = None
            self._train_s = 0.0
            self._ckpt_by_mode = {}
            self._ckpt_since_step = 0.0
            self._steps = 0
            self._active = {}

    def _export_fraction(self) -> None:
        with self._lock:
            ckpt_s = sum(self._ckpt_by_mode.values())
            total = self._train_s + ckpt_s
            if total <= 0 or self._steps == 0:
                return  # no train denominator yet (see snapshot())
            fraction = self._train_s / total
        REGISTRY.gauge(_m.GOODPUT_FRACTION).set(fraction)


# The process-wide accountant: snapshot.py's take/wait/restore paths
# report blocking through it; the train loop calls step() on it.
ACCOUNTANT = GoodputAccountant()


def step() -> None:
    ACCOUNTANT.step()


def blocked(mode: str):
    return ACCOUNTANT.blocked(mode)


def account(mode: str, seconds: float) -> None:
    ACCOUNTANT.account(mode, seconds)


def snapshot() -> Dict[str, Any]:
    return ACCOUNTANT.snapshot()


def has_data() -> bool:
    return ACCOUNTANT.has_data()


def reset() -> None:
    ACCOUNTANT.reset()
