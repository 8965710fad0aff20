"""A rank per card, for cells of more than one chip.

The process that the driver starts is rank 0. It makes the store's
directory, hosts a ``TCPStore``, starts ranks 1 … n−1 as child processes of
itself (the same command with the hidden ``--rank``, ``--world``,
``--master-port`` and ``--store-dir`` arguments) and relays each child's
output to its own standard error, every line prefixed ``[rank r]``. Every
rank then calls ``torch.distributed.init_process_group`` over that store,
on its own card ``cuda:<rank>``, so the port's ``get_coordinator()`` finds
its ``StoreCoordinator`` there as it does in a user's job.

Rank 0 makes the two decisions that depend on a clock, which cycle is the
window's last and which one starts the profiler, and publishes them in the
store at each cycle's start (:meth:`World.lockstep`); the other ranks read
them there. After the window each child sends its summary to rank 0 through
the store and exits; only rank 0 prints a result.

A child that exits non-zero, or a run whose children have not all reported
by their deadline (the set-up's, then 270 s past the window's), ends the
run: rank 0 prints ``no result`` with the rank and its last line, kills the
children, waits for them, removes the store's directory and exits non-zero.
A child dies with rank 0 (``PR_SET_PDEATHSIG``).

``shm`` storage is the port's fs plugin over a fresh directory under
``/dev/shm``: it must be tmpfs with room for two snapshots and a quarter
more, or the run prints no result; it never falls back to disk.
"""

import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

SHM_ROOT = "/dev/shm"
# Room the store needs: two snapshots (one committing while the last is
# kept), and a quarter more.
SHM_ROOM = 2 * 1.25
# Seconds a healthy run may take: its set-up (the first run in a checkout
# compiles), then from the window's deadline to every child's report.
SETUP_LIMIT_S = 1100.0
AFTER_WINDOW_S = 270.0
STORE_TIMEOUT_S = 300.0
_KEY = "perfbench/"
# Rank 0's process id, in each child's environment.
PARENT_ENV = "PERFBENCH_RANK0_PID"


class NoResult(Exception):
    """The run cannot be measured; the message says why."""


def tmpfs_mount(path: str) -> Optional[str]:
    """The file system type of the mount that holds ``path`` (the longest
    mount point above it in ``/proc/mounts``)."""
    real = os.path.realpath(path)
    best, kind = "", None
    try:
        lines = Path("/proc/mounts").read_text().splitlines()
    except OSError:
        return None
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        point = parts[1].replace("\\040", " ")
        inside = real == point or real.startswith(point.rstrip("/") + "/")
        if inside and len(point) > len(best):
            best, kind = point, parts[2]
    return kind


def make_shm_dir(name: str, state_bytes: int, root: str = SHM_ROOT) -> str:
    """A fresh directory under ``root`` that is tmpfs and has room for the
    store; raises :class:`NoResult` otherwise (and leaves nothing)."""
    if not os.path.isdir(root):
        raise NoResult(f"shm storage: {root} does not exist")
    kind = tmpfs_mount(root)
    if kind != "tmpfs":
        raise NoResult(f"shm storage: {root} is on {kind!r}, not tmpfs; the store never falls back to disk")
    stat = os.statvfs(root)
    free, need = stat.f_bavail * stat.f_frsize, int(SHM_ROOM * state_bytes)
    if free < need:
        raise NoResult(f"shm storage: {root} has {free} bytes free; two snapshots and a quarter more need {need}")
    return tempfile.mkdtemp(prefix=f"perfbench-{name}-", dir=root)


def make_store_dir(storage: str, name: str, state_bytes: int) -> str:
    """The directory that every rank's manager writes under."""
    if storage == "shm":
        return make_shm_dir(name, state_bytes)
    if storage == "fs":
        return tempfile.mkdtemp(prefix=f"perfbench-{name}-")
    raise NoResult(f"storage {storage!r} lives in one process; the ranks of a cell need one they share")


def write_bytes() -> Optional[int]:
    """This process's ``write_bytes`` from ``/proc/self/io``: bytes it
    caused to be sent to a block device."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return None


def _die_with_parent() -> None:
    """A child: SIGKILL when rank 0 ends (Linux), and an exit now if it
    already has."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    parent = os.environ.get(PARENT_ENV)
    if parent is not None and os.getppid() != int(parent):
        os._exit(6)


class Launcher:
    """Rank 0's children: started, relayed, watched, and ended."""

    def __init__(self, commands: Sequence[List[str]], setup_limit_s: float, cleanup: List[str],
                 has_reported: Callable[[int], bool]) -> None:
        self.deadline = time.monotonic() + setup_limit_s
        self.cleanup = cleanup
        self.has_reported = has_reported
        self.last_line: Dict[int, str] = {}
        self._failed = threading.Lock()
        self._stop = threading.Event()
        self.procs: Dict[int, subprocess.Popen] = {}
        env = dict(os.environ, **{PARENT_ENV: str(os.getpid())})
        for rank, cmd in enumerate(commands, start=1):
            self.procs[rank] = subprocess.Popen(cmd, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True, errors="replace", env=env)
        self._relays = [threading.Thread(target=self._relay, args=(rank, proc), name=f"perfbench-relay-{rank}",
                                         daemon=True) for rank, proc in self.procs.items()]
        for relay in self._relays:
            relay.start()
        self._monitor = threading.Thread(target=self._watch, name="perfbench-ranks", daemon=True)
        self._monitor.start()

    def _relay(self, rank: int, proc: subprocess.Popen) -> None:
        for line in proc.stdout:
            line = line.rstrip("\n")
            if line.strip():
                self.last_line[rank] = line
            sys.stderr.write(f"[rank {rank}] {line}\n")
            sys.stderr.flush()

    def _watch(self) -> None:
        while not self._stop.is_set():
            reason = self.exited(wait_s=0.0)
            if reason is not None:
                self.fail(reason)
            if time.monotonic() > self.deadline:
                late = [r for r in self.procs if not self.has_reported(r)]
                self.fail(f"rank(s) {late} did not report by the deadline; last lines: "
                          + json.dumps({str(r): self.last_line.get(r, "(none)") for r in late}))
            self._stop.wait(0.25)

    def fail(self, reason: str) -> None:
        """Print no result, end every child, remove the store, exit."""
        if not self._failed.acquire(blocking=False):
            return
        print(f"no result: {reason}", file=sys.stderr, flush=True)
        self.kill()
        for path in filter(None, self.cleanup):
            shutil.rmtree(path, ignore_errors=True)
        sys.stderr.flush()
        os._exit(5)

    def exited(self, wait_s: float = 5.0) -> Optional[str]:
        """What became of a child that ended before it reported, waiting a
        little for one to be reaped; None when none did."""
        end = time.monotonic() + wait_s
        while True:
            for rank, proc in self.procs.items():
                code = proc.poll()
                if code is not None and (code != 0 or not self.has_reported(rank)):
                    return (f"rank {rank} exited with code {code} before it reported; its last line: "
                            f"{self.last_line.get(rank, '(none)')!r}")
            if time.monotonic() > end:
                return None
            time.sleep(0.05)

    def shutdown(self) -> None:
        """Rank 0 is ending: no failure is reported from here on, and any
        child still running is ended."""
        self._failed.acquire(blocking=False)
        self._stop.set()
        self.kill()

    def kill(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs.values():
            proc.wait()
        for relay in self._relays:
            relay.join(timeout=10)

    def finish(self, timeout_s: float) -> None:
        """After every child reported: wait for each to exit 0."""
        end = time.monotonic() + timeout_s
        for rank, proc in self.procs.items():
            try:
                code = proc.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = None
            if code is None:
                self.fail(f"rank {rank} reported but did not exit within {timeout_s:g} s")
            elif code != 0:
                self.fail(f"rank {rank} exited with code {code}; its last line: "
                          f"{self.last_line.get(rank, '(none)')!r}")
        self._stop.set()
        self._monitor.join(timeout=5)
        for relay in self._relays:
            relay.join(timeout=10)


class World:
    """One rank's view: its rank, the world's size, the store, the store's
    directory and, on rank 0, the children."""

    def __init__(self, rank: int, size: int, store: Any, store_dir: str,
                 launcher: Optional[Launcher] = None) -> None:
        self.rank, self.size, self.store, self.store_dir = rank, size, store, store_dir
        self.launcher = launcher
        self.lockstep_s = 0.0
        self.lockstep_calls = 0

    def lockstep(self, cycle: int, last: bool, profile: bool) -> Tuple[bool, bool]:
        """Rank 0's decisions for ``cycle``, published by rank 0 and read by
        the others; the seconds it costs each rank are kept."""
        t0 = time.monotonic()
        key = f"{_KEY}cycle/{cycle}"
        if self.rank == 0:
            self.store.set(key, f"{int(last)}{int(profile)}")
        else:
            value = self.store.get(key).decode()
            last, profile = value[0] == "1", value[1] == "1"
        self.lockstep_s += time.monotonic() - t0
        self.lockstep_calls += 1
        return last, profile

    def failure(self, error: BaseException) -> str:
        """Why this rank's run failed: on rank 0, a child that ended first
        is the cause; else the error itself."""
        found = self.launcher.exited() if self.launcher is not None else None
        return found or f"rank {self.rank}: {error!r}"

    def window_starts(self, seconds: float) -> None:
        """Rank 0: the children's deadline is now the window's, and 270 s."""
        if self.launcher is not None:
            self.launcher.deadline = time.monotonic() + seconds + AFTER_WINDOW_S

    def gather(self, summary: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
        """Every rank's summary on rank 0, in rank order (None elsewhere).
        A child sends its own; rank 0 waits for each. Then every rank leaves
        the process group together (NCCL's teardown waits for all ranks),
        and rank 0 waits for every child to exit."""
        import torch.distributed as dist

        if self.rank != 0:
            self.store.set(f"{_KEY}summary/{self.rank}", json.dumps(summary))
            dist.destroy_process_group()
            return None
        out = [summary]
        for rank in range(1, self.size):
            key = f"{_KEY}summary/{rank}"
            while not self.store.check([key]):
                time.sleep(0.05)
            out.append(json.loads(self.store.get(key)))
        dist.destroy_process_group()
        if self.launcher is not None:
            self.launcher.finish(timeout_s=120.0)
        return out

    def close(self, leave_group: bool = True) -> None:
        """Rank 0 ends any child still running and removes the store's
        directory; then the rank leaves the process group, unless a rank
        failed (a group with a dead member may not be left)."""
        import torch.distributed as dist

        if self.launcher is not None:
            self.launcher.shutdown()
            if self.store_dir:
                shutil.rmtree(self.store_dir, ignore_errors=True)
        if leave_group and dist.is_initialized():
            dist.destroy_process_group()


def start(rank: Optional[int], size: int, port: Optional[int], store_dir: Optional[str],
          child_command: Optional[List[str]], storage: Optional[str], name: str, state_bytes: int,
          device: str, setup_limit_s: float = SETUP_LIMIT_S) -> World:
    """Rank 0 (``rank`` None): make the store's directory (none for
    ``storage`` None), host the store, start the children, join the process
    group. A child: die with rank 0, take its card, join. NCCL on CUDA,
    gloo on the CPU."""
    import torch
    import torch.distributed as dist

    if rank is not None:
        _die_with_parent()
    me = 0 if rank is None else rank
    if device == "cuda":
        torch.cuda.set_device(me)
    timeout = timedelta(seconds=STORE_TIMEOUT_S)
    launcher = None
    if rank is None:
        store_dir = make_store_dir(storage, name, state_bytes) if storage is not None else ""
        try:
            store = dist.TCPStore("127.0.0.1", 0, size, is_master=True, timeout=timeout,
                                  wait_for_workers=False)
            hidden = ["--world", str(size), "--master-port", str(store.port), "--store-dir", store_dir]
            commands = [child_command + ["--rank", str(r)] + hidden for r in range(1, size)]
            launcher = Launcher(commands, setup_limit_s, cleanup=[store_dir],
                                has_reported=lambda r: store.check([f"{_KEY}summary/{r}"]))
        except BaseException:
            shutil.rmtree(store_dir, ignore_errors=True)
            raise
    else:
        store = dist.TCPStore("127.0.0.1", port, size, is_master=False, timeout=timeout)
    backend = "nccl" if device == "cuda" else "gloo"
    kwargs = {"device_id": torch.device("cuda", me)} if device == "cuda" else {}
    world = World(me, size, store, store_dir, launcher)
    try:
        dist.init_process_group(backend, store=store, rank=me, world_size=size, **kwargs)
    except BaseException:
        world.close(leave_group=False)
        raise
    return world
