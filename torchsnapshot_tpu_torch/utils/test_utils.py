"""Test utilities: state-dict equality and multi-rank launchers.

- :func:`check_state_dict_eq` — structural equality of two state dicts,
  bit-exact by default; tensors compare by their bytes, DTensors by
  their local shards (never through DTensor dispatch, which may issue a
  collective).
- :func:`run_thread_ranks` — ``world`` threads of this process, each a
  rank of a ``StoreCoordinator`` over one shared ``DictStore``: cheap
  enough for world sizes that real processes cannot reach in a test.
- :func:`run_multiprocess` — ``nprocs`` spawned processes that join one
  gloo process group, so ``get_coordinator()`` and DeviceMesh work in
  them as in a real job.
"""

import datetime
import multiprocessing as mp
import queue
import threading
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..coord import DictStore, Store, StoreCoordinator
from ..io_preparer import is_dtensor
from ..serialization import tensor_bytes


def _as_array(x: Any) -> Any:
    """The tensor or array of a leaf (a DTensor's local shard), or None."""
    if is_dtensor(x):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return x
    return None


def _leaf_eq(a: Any, b: Any, exact: bool) -> bool:
    if is_dtensor(a) != is_dtensor(b):
        return False
    if is_dtensor(a) and (
        a.device_mesh != b.device_mesh or tuple(a.placements) != tuple(b.placements)
    ):
        return False
    a_arr, b_arr = _as_array(a), _as_array(b)
    if a_arr is None or b_arr is None:
        return a_arr is None and b_arr is None and bool(a == b)
    if isinstance(a_arr, np.ndarray):
        a_arr = torch.from_numpy(np.array(a_arr, copy=True))
    if isinstance(b_arr, np.ndarray):
        b_arr = torch.from_numpy(np.array(b_arr, copy=True))
    if a_arr.dtype != b_arr.dtype or a_arr.shape != b_arr.shape:
        return False
    a_cpu, b_cpu = a_arr.detach().cpu(), b_arr.detach().cpu()
    if exact:
        return torch.equal(tensor_bytes(a_cpu), tensor_bytes(b_cpu))
    if a_cpu.is_floating_point() or a_cpu.is_complex():
        return torch.allclose(a_cpu.double(), b_cpu.double())
    return torch.equal(a_cpu, b_cpu)


def check_state_dict_eq(a: Any, b: Any, exact: bool = True) -> bool:
    """Structural equality of two state dicts, tensor-aware."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(map(str, a.keys())) != set(map(str, b.keys())):
            return False
        b_by_str = {str(k): v for k, v in b.items()}
        return all(check_state_dict_eq(v, b_by_str[str(k)], exact) for k, v in a.items())
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        return all(check_state_dict_eq(x, y, exact) for x, y in zip(a, b))
    return _leaf_eq(a, b, exact)


def assert_state_dict_eq(a: Any, b: Any, exact: bool = True) -> None:
    assert check_state_dict_eq(a, b, exact), (
        f"State dicts differ:\n--- a ---\n{a}\n--- b ---\n{b}"
    )


def run_thread_ranks(
    world: int,
    fn: Callable[[StoreCoordinator, int], Any],
    store: Optional[Store] = None,
    timeout_s: float = 120.0,
) -> List[Any]:
    """Run ``fn(coordinator, rank)`` on ``world`` threads coordinating
    over one shared store (a ``DictStore`` by default); returns the
    per-rank results. Any rank's failure, or a rank still running at the
    shared deadline, fails the call."""
    store = store if store is not None else DictStore()
    results: List[Any] = [None] * world
    errors: List[Any] = []

    def worker(rank: int) -> None:
        try:
            coord = StoreCoordinator(store, rank, world, timeout_s=timeout_s)
            results[rank] = fn(coord, rank)
        except BaseException:  # surfaced below
            errors.append((rank, traceback.format_exc()))

    threads = [
        threading.Thread(target=worker, args=(r,), daemon=True) for r in range(world)
    ]
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.start()
    for t in threads:
        # One shared deadline: sequential full-timeout joins would wait
        # world × timeout_s before reporting a deadlock.
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    if errors:
        raise AssertionError(f"rank {errors[0][0]} failed:\n{errors[0][1]}")
    hung = [r for r, t in enumerate(threads) if t.is_alive()]
    if hung:
        raise AssertionError(f"rank(s) {hung} still running after {timeout_s}s")
    return results


# Seconds the other ranks get to finish after one rank failed.
_FAILURE_GRACE_S = 10.0


def _mp_worker(
    fn: Callable, rank: int, nprocs: int, port: int, args: tuple, errors: Any
) -> None:
    import torch.distributed as dist

    try:
        store = dist.TCPStore(
            "127.0.0.1", port, is_master=False, timeout=datetime.timedelta(seconds=300)
        )
        dist.init_process_group("gloo", store=store, rank=rank, world_size=nprocs)
        try:
            fn(rank, nprocs, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise


def run_multiprocess(
    fn: Callable, nprocs: int, args: tuple = (), timeout_s: float = 120.0
) -> None:
    """Spawn ``nprocs`` processes running ``fn(rank, nprocs, *args)``
    inside one gloo process group; raise if any fails.

    The group meets at a ``TCPStore`` this process opens on a free port
    (port 0; never a fixed ``MASTER_PORT``, so launches side by side do
    not meet). ``fn`` and ``args`` must pickle (a module-level function).
    All ranks share one join deadline: a rank still running then is
    killed and fails the call, without a wait of its own."""
    import torch.distributed as dist

    server = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    ctx = mp.get_context("spawn")
    errors = ctx.Queue()
    procs = [
        ctx.Process(target=_mp_worker, args=(fn, rank, nprocs, server.port, args, errors))
        for rank in range(nprocs)
    ]
    for p in procs:
        p.start()
    failures = []
    deadline = time.monotonic() + timeout_s
    try:
        # Drain the error queue while waiting: joining a process whose
        # queue writes are unread can deadlock.
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            try:
                failures.append(errors.get(timeout=0.1))
            except queue.Empty:
                continue
            # The other ranks wait on the failed one in a collective: give
            # them a grace to report their own failures, not the deadline.
            deadline = min(deadline, time.monotonic() + _FAILURE_GRACE_S)
    finally:
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    while True:
        try:
            failures.append(errors.get(timeout=0.1))
        except queue.Empty:
            break
    for rank, p in enumerate(procs):
        if p.exitcode != 0 and rank not in [r for r, _ in failures] and rank not in hung:
            failures.append((rank, f"exit code {p.exitcode}"))
    if hung:
        failures.append((hung, f"still running after {timeout_s}s; killed"))
    if failures:
        raise RuntimeError(
            "Worker failures:\n" + "\n".join(f"rank {r}: {msg}" for r, msg in failures)
        )
