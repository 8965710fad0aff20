"""Pooled host staging buffers for the restore pipeline.

A restore stages every payload it places on a device through host memory
it owns: a sub-read's bytes on their way to the card, a split object's
assembly buffer. Restore plans repeat sizes heavily (all of a model's
layers share a handful of shapes), so a process-wide pool of exact-size
buffers turns that churn into reuse. On the card the buffers are
**pinned** (a plan asks for pinned memory when its target is a CUDA
tensor): the H2D pipeline reads a pooled buffer directly, with no bounce
copy, and a second restore of the same model pins no new memory.

Contracts:

- A lease carries at most ONE scheduler budget re-credit, attached with
  :meth:`StagingLease.set_budget_release` and fired exactly once, when the
  buffer actually returns to the pool, whatever mix of threads and error
  paths releases it.
- A lease goes back to the pool only after every reader holding it has
  dropped its hold (:meth:`StagingLease.hold` / :meth:`StagingLease.drop`):
  the H2D pipeline holds a lease from submit until the CUDA event of its
  DMA has completed, so the next acquirer never overwrites bytes in
  flight.

Env knobs (the JAX package's names):

- ``TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES``: pool capacity (default
  1 GiB). Bounds the retained free set and the point past which new
  acquisitions wait for a release. ``0`` disables pooling (every lease
  is then a plain allocation, freed on release).
- ``TPUSNAPSHOT_RESTORE_POOL_WAIT_S``: the longest an acquisition waits
  at capacity before it allocates past the cap (default 5). The cap is a
  pressure valve: the scheduler's host budget is the real bound, so the
  pool never deadlocks a pipeline the budget admitted.
"""

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import telemetry
from .telemetry import consume_profile as _cprof
from .telemetry import memwatch
from .telemetry import metrics as _metric_names
from .utils.env import env_float, env_int

_POOL_BYTES_ENV_VAR = "TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES"
_DEFAULT_POOL_BYTES = 1 << 30
_POOL_WAIT_ENV_VAR = "TPUSNAPSHOT_RESTORE_POOL_WAIT_S"
_DEFAULT_POOL_WAIT_S = 5.0

_Key = Tuple[int, bool]  # (nbytes, pinned)


def pool_capacity_bytes() -> int:
    return env_int(_POOL_BYTES_ENV_VAR, _DEFAULT_POOL_BYTES)


def _allocate(nbytes: int, pinned: bool) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)


class StagingLease:
    """One staging buffer (a 1-D uint8 host tensor, pinned or not),
    owned by one consumer at a time.

    ``release()`` is idempotent: the first call marks the lease released;
    the buffer goes back to the pool (and the attached budget re-credit
    fires, once) when the last hold has also dropped.
    """

    __slots__ = ("buffer", "nbytes", "pinned", "_pool", "_released", "_returned",
                 "_holds", "_budget_cb", "_budget_nbytes", "_lock")

    def __init__(
        self, pool: Optional["StagingPool"], buffer: torch.Tensor, pinned: bool
    ) -> None:
        self.buffer = buffer
        self.nbytes = buffer.numel()
        self.pinned = pinned
        self._pool = pool
        self._released = False
        self._returned = False
        self._holds = 0
        self._budget_cb: Optional[Callable[[int], None]] = None
        self._budget_nbytes = 0
        self._lock = threading.Lock()

    def set_budget_release(self, cb: Callable[[int], None], nbytes: int) -> None:
        """Attach the scheduler's re-credit for this buffer's reservation,
        fired once when the buffer returns (at once if it already has)."""
        with self._lock:
            fire = self._returned
            if not fire:
                self._budget_cb = cb
                self._budget_nbytes = nbytes
        if fire:
            cb(nbytes)

    def hold(self) -> None:
        """A reader (an in-flight DMA) starts using the buffer."""
        with self._lock:
            if self._returned:
                raise RuntimeError("staging lease used after it returned to the pool")
            self._holds += 1

    def drop(self) -> None:
        """A reader is done with the buffer (its DMA has completed)."""
        with self._lock:
            self._holds -= 1
        self._maybe_return()

    def release(self) -> None:
        with self._lock:
            self._released = True
        self._maybe_return()

    def _maybe_return(self) -> None:
        with self._lock:
            if self._returned or not self._released or self._holds:
                return
            self._returned = True
            cb, self._budget_cb = self._budget_cb, None
            nbytes = self._budget_nbytes
        if cb is not None:
            cb(nbytes)
        if self._pool is not None:
            self._pool._give_back(self.buffer, (self.nbytes, self.pinned))

    def __del__(self) -> None:
        # Error paths (a failed restore dropping its plan mid-flight): an
        # unreachable lease has no pipeline reader left (a reader holds a
        # reference until its drop), so returning it keeps the pool's
        # in-use accounting right across repeated failures.
        try:
            self.release()
        except Exception:  # snapcheck: disable=swallowed-exception -- GC-time best effort
            pass


class StagingPool:
    """Exact-size free lists with a byte cap and bounded waits."""

    def __init__(self, capacity_bytes: int, max_wait_s: Optional[float] = None) -> None:
        self.capacity_bytes = capacity_bytes
        self.max_wait_s = (
            max_wait_s if max_wait_s is not None
            else env_float(_POOL_WAIT_ENV_VAR, _DEFAULT_POOL_WAIT_S)
        )
        self._cond = threading.Condition()
        self._free: Dict[_Key, List[torch.Tensor]] = {}
        self._free_bytes = 0
        self._in_use_bytes = 0
        self._high_water_bytes = 0
        self._counts = {"hits": 0, "misses": 0, "waits": 0, "pinned_allocs": 0}
        # Retained plus leased bytes against the cap. Leases are pinned
        # (a live restore holds them); retained free buffers can be
        # evicted, so the leak watch follows the leased side.
        self._mem_domain = memwatch.register(
            "staging_pool", cap_bytes=capacity_bytes, watch_residual="pinned"
        )
        weakref.finalize(self, self._mem_domain.close)

    def acquire(
        self,
        nbytes: int,
        profile: Optional[_cprof.ConsumeProfile] = None,
        pinned: bool = False,
    ) -> StagingLease:
        """A buffer of exactly ``nbytes`` (pinned if asked), reused when
        the pool holds one. At capacity (live leases plus the request
        past the cap) the call waits, at most ``max_wait_s``, for a
        release, noted into ``profile`` as ``pool_wait``; it then
        allocates past the cap rather than deadlock the pipeline."""
        key = (nbytes, pinned)
        with self._cond:
            buf = self._take_free_locked(key)
            if buf is None:
                # Retained buffers of other sizes are idle: evict them to
                # make room rather than stall behind them.
                self._evict_free_locked(nbytes)
            if buf is None and self._must_wait_locked(nbytes):
                with _cprof.substep(profile, "pool_wait", nbytes):
                    deadline = time.monotonic() + self.max_wait_s
                    while buf is None and self._must_wait_locked(nbytes):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                        buf = self._take_free_locked(key)
                self._counts["waits"] += 1
                telemetry.counter(_metric_names.RESTORE_POOL_WAITS).inc(1)
                self._mem_domain.counter("waits")
                if buf is None:
                    buf = self._take_free_locked(key)
                # A release wakes one waiter (not the herd, which would
                # crowd every thread of the restore onto the GIL); pass
                # the wake-up on, in case what is left fits another.
                self._cond.notify()
            hit = buf is not None
            self._counts["hits" if hit else "misses"] += 1
            if hit:
                telemetry.counter(_metric_names.RESTORE_POOL_HITS).inc(1)
                self._mem_domain.counter("hits")
            else:
                self._counts["pinned_allocs"] += int(pinned)
                telemetry.counter(_metric_names.RESTORE_POOL_MISSES).inc(1)
                self._mem_domain.counter("misses")
            self._in_use_bytes += nbytes
            self._publish_locked()
        if buf is None:
            # Outside the lock: pinning takes a while, and page-locking a
            # large buffer must not stall every other acquisition.
            buf = _allocate(nbytes, pinned)
        return StagingLease(self, buf, pinned)

    def _take_free_locked(self, key: _Key) -> Optional[torch.Tensor]:
        bucket = self._free.get(key)
        if not bucket:
            return None
        buf = bucket.pop()
        if not bucket:
            del self._free[key]
        self._free_bytes -= key[0]
        return buf

    def _evict_free_locked(self, need_bytes: int) -> None:
        """Drop retained free buffers until ``need_bytes`` fits in the cap
        beside the live leases. When live leases alone exceed the cap,
        keep the cache: in-flight restores re-acquire those sizes next."""
        if self._in_use_bytes + need_bytes > self.capacity_bytes:
            return
        while (
            self._free_bytes > 0
            and self._in_use_bytes + self._free_bytes + need_bytes > self.capacity_bytes
        ):
            key = next(iter(self._free))
            bucket = self._free[key]
            bucket.pop()
            if not bucket:
                del self._free[key]
            self._free_bytes -= key[0]

    def _must_wait_locked(self, nbytes: int) -> bool:
        # Free bytes are evictable; only live leases force a wait.
        return self._in_use_bytes > 0 and self._in_use_bytes + nbytes > self.capacity_bytes

    def _give_back(self, buffer: torch.Tensor, key: _Key) -> None:
        with self._cond:
            self._in_use_bytes -= key[0]
            if self._free_bytes + key[0] <= self.capacity_bytes:
                self._free.setdefault(key, []).append(buffer)
                self._free_bytes += key[0]
            self._publish_locked()
            self._cond.notify()

    def _publish_locked(self) -> None:
        """Mirror occupancy into the gauges and the memwatch domain
        (retained plus leased against the cap, leases pinned), under the
        pool's condition, after every change of bytes."""
        total = self._free_bytes + self._in_use_bytes
        self._high_water_bytes = max(self._high_water_bytes, total)
        telemetry.gauge(_metric_names.RESTORE_POOL_RETAINED).set(float(self._free_bytes))
        telemetry.gauge(_metric_names.RESTORE_POOL_LEASED).set(float(self._in_use_bytes))
        telemetry.gauge(_metric_names.RESTORE_POOL_HWM).set(float(self._high_water_bytes))
        self._mem_domain.set_used(total, pinned_bytes=self._in_use_bytes)

    def stats(self) -> Dict[str, int]:
        """Occupancy and, since the pool was made, its hits, misses,
        capacity waits and pinned allocations."""
        with self._cond:
            return {
                "free_bytes": self._free_bytes,
                "in_use_bytes": self._in_use_bytes,
                "capacity_bytes": self.capacity_bytes,
                "high_water_bytes": self._high_water_bytes,
                **self._counts,
            }


_pool_lock = threading.Lock()
_pool: List[Optional[StagingPool]] = []


def get_staging_pool() -> Optional[StagingPool]:
    """The process-wide pool, or None when pooling is disabled
    (``TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES=0``). The capacity is read
    once per process; tests call :func:`reset_staging_pool`."""
    with _pool_lock:
        if not _pool:
            cap = pool_capacity_bytes()
            _pool.append(StagingPool(cap) if cap > 0 else None)
        return _pool[0]


def reset_staging_pool() -> None:
    """Drop the memoized pool (tests re-read the env knobs)."""
    with _pool_lock:
        _pool.clear()


def acquire(
    nbytes: int,
    profile: Optional[_cprof.ConsumeProfile] = None,
    pinned: bool = False,
) -> StagingLease:
    """A lease from the process pool, or a plain allocation wrapped as a
    lease when pooling is disabled, so callers have one release path."""
    pool = get_staging_pool()
    if pool is None:
        return StagingLease(None, _allocate(nbytes, pinned), pinned)
    return pool.acquire(nbytes, profile, pinned)
