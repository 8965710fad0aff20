#!/usr/bin/env python3
"""Where the restore's host→device pipeline spends its time, on the card.

    python3 tools/h2d_pipeline_probe.py [--transfers 200] [--mb 40.96]

Prints one JSON line per case, then the card's name and power limit:

- ``pipeline_*``: ``H2DPipeline.submit`` of pinned buffers (staging-pool
  leases, reused) into one device buffer, depth 2 and 8, with nothing
  else running, beside 16 threads copying host payloads into pinned
  memory and folding crc32 over them (a restore's consume work), the copy
  by ``host_copy`` (GIL released) or by a numpy slice assignment (GIL
  held; ``--python`` adds 16 threads running Python). Each line has the
  GB/s over the wall, and the worker's seconds split into the wait on the
  producer's event and the blocking ``copy_`` (from a timed copy of the
  worker's steps).
- ``threads_16``: the old way, each of 16 threads issuing its own copies
  and synchronizing them, beside the same consume work.
- ``restore_*``: ``Snapshot.restore`` of a synthetic state (48 leaves of
  ``--mb`` MB) from a scratch directory into CUDA templates, with the
  consume profile of ``snapshot._last_restore_report``: defaults, depth
  8, and a 4 GiB staging pool.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torchsnapshot_tpu_torch import Snapshot, StateDict, staging_pool  # noqa: E402
from torchsnapshot_tpu_torch import snapshot as snapshot_mod  # noqa: E402
from torchsnapshot_tpu_torch.ops import transfer  # noqa: E402


def emit(record):
    print(json.dumps(record), flush=True)


class Background:
    """``n`` threads doing one kind of work until stopped."""

    def __init__(self, kind, n, nbytes):
        self.stop = threading.Event()
        payload = os.urandom(nbytes)

        def consume():
            pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            while not self.stop.is_set():
                transfer.host_copy(pinned, payload)
                zlib.crc32(payload)

        def numpy_copy():
            pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            while not self.stop.is_set():
                pinned.numpy()[:] = np.frombuffer(payload, dtype=np.uint8)
                zlib.crc32(payload)

        def python():
            x = 0
            while not self.stop.is_set():
                for i in range(1000):
                    x += i

        target = {"consume": consume, "numpy_copy": numpy_copy, "python": python}[kind]
        self.threads = [threading.Thread(target=target, daemon=True) for _ in range(n)]

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join()


def timed_steps(src, dst, n, ready):
    """The pipeline worker's steps, timed one by one, on this thread."""
    stream = torch.cuda.Stream()
    parts = {"wait_event": 0.0, "blocking_copy": 0.0}
    for _ in range(n):
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            if not ready.query():
                stream.wait_event(ready)
            t1 = time.perf_counter()
            dst.copy_(src)
            t2 = time.perf_counter()
        parts["wait_event"] += t1 - t0
        parts["blocking_copy"] += t2 - t1
    return parts


def pipeline_case(name, depth, n, nbytes, background=None):
    pool = staging_pool.StagingPool(capacity_bytes=16 * nbytes)
    engine = transfer.H2DPipeline(depth=depth)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream())
    warm = [pool.acquire(nbytes, pinned=True) for _ in range(8)]
    for lease in warm:
        lease.release()
    torch.cuda.synchronize()
    ctx = Background(background, 16, nbytes) if background else None
    if ctx:
        ctx.__enter__()
    try:
        begin = time.perf_counter()
        futures = []
        for _ in range(n):
            lease = pool.acquire(nbytes, pinned=True)
            futures.append(engine.submit(lease.buffer, dst, ready=ready, lease=lease))
            lease.release()
        for fut in futures:
            fut.result()
        wall = time.perf_counter() - begin
        src = pool.acquire(nbytes, pinned=True)
        parts = timed_steps(src.buffer, dst, min(n, 50), ready)
        src.release()
    finally:
        if ctx:
            ctx.__exit__()
    emit({"case": name, "depth": depth, "transfers": n, "bytes_each": nbytes,
          "wall_s": wall, "gbps": n * nbytes / 1e9 / wall,
          "worker_steps_s_per_transfer": {k: v / min(n, 50) for k, v in parts.items()},
          "pool": pool.stats()})


def threads_case(n, nbytes):
    """16 threads each issuing and synchronizing its own copies."""
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    per = n // 16
    with Background("consume", 16, nbytes):
        def run():
            src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            stream = torch.cuda.Stream()
            for _ in range(per):
                with torch.cuda.stream(stream):
                    dst.copy_(src, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                done.synchronize()

        threads = [threading.Thread(target=run) for _ in range(16)]
        begin = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - begin
    emit({"case": "threads_16", "transfers": per * 16, "bytes_each": nbytes,
          "wall_s": wall, "gbps": per * 16 * nbytes / 1e9 / wall})


def restore_case(name, path, state, env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    staging_pool.reset_staging_pool()
    transfer._reset_h2d_pipeline_for_tests()
    try:
        target = StateDict(**{k: torch.zeros_like(v) for k, v in state.items()})
        torch.cuda.synchronize()
        begin = time.perf_counter()
        Snapshot(path).restore({"m": target})
        torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        equal = all(torch.equal(target[k], v) for k, v in state.items())
        block = snapshot_mod._last_restore_report
        subs = block["substeps"]
        total = sum(v.numel() * v.element_size() for v in state.values())
        emit({"case": name, "env": env, "bytes": total, "wall_s": wall,
              "gbps": total / 1e9 / wall, "equal": equal,
              "substeps": {k: {"seconds": e["seconds"], "bytes": e["bytes"]} for k, e in subs.items()},
              "h2d_overlap_gbps": block.get("h2d_overlap_gbps"),
              "read_s": block["scheduler"]["ops"]["read"]["seconds"],
              "pool": staging_pool.get_staging_pool().stats()})
        if not equal:
            raise AssertionError(f"{name}: restored leaves differ")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        staging_pool.reset_staging_pool()
        transfer._reset_h2d_pipeline_for_tests()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--transfers", type=int, default=200)
    parser.add_argument("--mb", type=float, default=40.96)
    parser.add_argument("--python", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("h2d_pipeline_probe.py needs a CUDA device.", file=sys.stderr)
        return 2
    nbytes = int(args.mb * 1e6)
    n = args.transfers
    pipeline_case("pipeline_alone", 2, n, nbytes)
    pipeline_case("pipeline_consume16", 2, n, nbytes, "consume")
    pipeline_case("pipeline_numpy_copy16", 2, n // 4, nbytes, "numpy_copy")
    if args.python:
        pipeline_case("pipeline_python16", 2, n // 4, nbytes, "python")
    pipeline_case("pipeline_consume16_depth8", 8, n, nbytes, "consume")
    threads_case(n, nbytes)
    workdir = tempfile.mkdtemp(prefix="h2d_probe-")
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = {f"w{i}": torch.randn(nbytes // 4, generator=gen, device="cuda") for i in range(48)}
        path = os.path.join(workdir, "snap")
        Snapshot.take(path, {"m": StateDict(**state)})
        restore_case("restore_default", path, state, {})
        restore_case("restore_depth8", path, state, {"TPUSNAPSHOT_H2D_DEPTH": "8"})
        restore_case("restore_pool_4gib", path, state,
                     {"TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES": str(4 << 30)})
        restore_case("restore_default_again", path, state, {})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
