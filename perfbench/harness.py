"""One run of one cell: set-up, the measured window, the checks, one line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is found by its name in ``BENCHMARK.json``:

- the cell's ``config`` names an entry of ``configs``, whose ``file`` holds
  the sizes and names the ``family``: ``perfbench/families/<family>.py`` (the
  port's model as a job) and ``perfbench/reference/<family>.py`` (its plain
  reference, which also makes the seeded inputs);
- the cell's ``traffic`` is ``perfbench/traffic/<traffic>.json``, read by the
  one generator, ``cycles.py``, which finds the mix's checkpoint operation
  as ``perfbench/operations/<operation>.py`` and passes the mix's manager
  and call keyword arguments on as they are; a mix's ``layout`` picks the
  family ``perfbench/families/<family>_<layout>.py``, a rank per card;
- each per-layer metric is ``perfbench/metrics/<name>.py``.

An unknown name fails the run before any work. A cell of more than one chip
runs a rank per card (``perfbench/ranks.py``): every rank runs
:func:`run_cell` on its own card, and rank 0 prints the line.
"""

import argparse
import gc
import hashlib
import importlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench import checks, cycles, guard, ranks, tracer
from perfbench.metrics import save_stall_s

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "perfbench"
# The first steps the reference follows.
CHECKED_STEPS = 3


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for one purpose, from the run's seed."""
    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: Dict[str, Any], workload: str, root: Path = ROOT) -> Dict[str, Any]:
    """The cell's configuration, traffic, metrics and modules, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((PACKAGE / "traffic" / f"{cell['traffic']}.json").read_text())
    cycles.validate(traffic)
    family = config["family"]
    if ("layout" in traffic) != (int(cell["chips"]) > 1):
        raise ValueError(f"{workload}: a mix with a layout runs a rank per card, on more than one chip; "
                         f"a cell of more than one chip needs one")
    if "layout" in traffic:
        family = f"{family}_{traffic['layout']}"
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in spec["end_to_end"] if _applies(m, workload)],
        "per_layer": per_layer,
        "family": importlib.import_module(f"perfbench.families.{family}"),
        "readers": {m["name"]: _reader(m["name"]) for m in per_layer},
    }


def _reader(name: str) -> Any:
    """``perfbench/metrics/<name>.py``."""
    module = importlib.import_module(f"perfbench.metrics.{name}")
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"perfbench/metrics/{name}.py has no read(ctx)")
    return module


def _store(traffic: Dict[str, Any], name: str, seed: int, state_bytes: int) -> str:
    """The manager's base path for the mix's storage, new for this run."""
    if traffic["storage"] == "fs":
        return tempfile.mkdtemp(prefix=f"perfbench-{name}-")
    if traffic["storage"] == "shm":
        return ranks.make_shm_dir(name, state_bytes)
    # memory:// buckets live as long as the process.
    return f"memory://perfbench-{name}-{seed}-{time.monotonic_ns()}/run"


def _drop_store(base: str) -> None:
    from torchsnapshot_tpu_torch import storage_plugin

    if base.startswith("memory://"):
        storage_plugin._MEMORY_STORES.pop(base[len("memory://"):].split("/")[0], None)
    else:
        shutil.rmtree(base, ignore_errors=True)


def _host_memory_line(state_bytes: int) -> str:
    available = "unknown"
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                available = f"{int(line.split()[1]) * 1024 / 1e9:.3f} GB"
    except OSError:
        pass
    # Two snapshots in memory:// while a new one commits, and the 1 GiB
    # restore staging pool.
    need = (2 * state_bytes + (1 << 30)) / 1e9
    return f"host memory: MemAvailable {available}; the mix needs about {need:.3f} GB"


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return f"card: {out.stdout.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: nvidia-smi unavailable ({e!r})"


def _first_steps(job: Any) -> Dict[str, Any]:
    """Drive the job through its first steps through the window's own call
    and feed, keeping what the reference is compared on."""
    start = [p.clone() for p in job.param_tensors()]
    losses = [float(job.step())]
    grad1 = job.first_grad_norms(start)
    losses += [float(job.step()) for _ in range(CHECKED_STEPS - 1)]
    if hasattr(job, "change_norms"):  # a sharded job: norms of whole leaves
        change = job.change_norms(start)
    else:
        change = [float((p.double() - q.double()).norm()) for p, q in zip(job.param_tensors(), start)]
    del start
    return {"losses": losses, "grad1": grad1, "change": change}


def _shard_census(manager: Any) -> str:
    """The last committed snapshot's sharded entries: how many shards each
    leaf has once the ranks' manifests are merged, and the payload bytes of
    the shards each rank wrote."""
    from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry, get_available_entries
    from torchsnapshot_tpu_torch.serialization import dtype_itemsize
    from torchsnapshot_tpu_torch.snapshot import Snapshot

    try:
        manifest = Snapshot(f"{manager.base_path}/step-{manager.latest_step()}").get_manifest()
        by_rank: Dict[int, int] = {}
        for path, entry in manifest.items():
            if isinstance(entry, ShardedArrayEntry):
                owner = int(path.split("/", 1)[0])
                by_rank[owner] = by_rank.get(owner, 0) + sum(
                    math.prod(shard.sizes) * dtype_itemsize(entry.dtype) for shard in entry.shards)
        counts: Dict[int, int] = {}
        for entry in get_available_entries(manifest, 0).values():
            if isinstance(entry, ShardedArrayEntry):
                counts[len(entry.shards)] = counts.get(len(entry.shards), 0) + 1
        return (f"sharded leaves {sum(counts.values())}, shards per leaf {json.dumps(counts)}, "
                f"payload bytes written by rank {json.dumps(dict(sorted(by_rank.items())))}")
    except Exception as e:  # a diagnostic line: never fails the run
        return f"unreadable ({e!r})"


def run_cell(resolved: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str,
             t0: float, out_dir: Path = OUT_DIR, world: Optional[ranks.World] = None) -> Optional[Dict[str, Any]]:
    """Set-up, window, checks; the result line as a dict. With ``world``,
    this rank's part: rank 0 gets every rank's summary and returns the line,
    the others return None."""
    from torchsnapshot_tpu_torch import tracing
    from torchsnapshot_tpu_torch.manager import CheckpointManager
    from torchsnapshot_tpu_torch.telemetry import goodput

    cell, config, traffic = resolved["cell"], resolved["config"], resolved["traffic"]
    name = cell["name"]
    cuda = device == "cuda"
    lead = world is None or world.rank == 0
    trace = trace and lead  # only rank 0 profiles
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weight_seed = derive_seed(seed, "weights")
    batch_seed = derive_seed(seed, "batches" if world is None else f"batches.rank{world.rank}")

    job = resolved["family"].Job(config, weight_seed, batch_seed, device)
    state_bytes = sum(t.numel() * t.element_size() for t in job.state_tensors())
    if lead:
        print(_host_memory_line(state_bytes), file=sys.stderr, flush=True)
    if cuda and lead:
        print(_card_line(), file=sys.stderr, flush=True)
    program = _first_steps(job)

    base = _store(traffic, name, seed, state_bytes) if world is None else f"{world.store_dir}/run"
    manager = CheckpointManager(base, **traffic["manager"])
    rec = cycles.Recorder(annotate=trace)
    profiler = tracer.Profiler(cuda) if trace else None
    window = cycles.Window(job, manager, traffic, rec, watch_drains=trace, profiler=profiler,
                           lockstep=None if world is None else world.lockstep)
    window.prepare()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans_path = out_dir / f"{name}.spans.json"
    if trace:
        out_dir.mkdir(parents=True, exist_ok=True)
        tracing.enable(str(spans_path))
    blocked0 = goodput.snapshot()["by_mode"]
    written0 = ranks.write_bytes() if world is not None else None
    setup_s = time.monotonic() - t0

    if world is not None:
        world.window_starts(seconds)
        if lead:
            print(f"window starts: {seconds:g} s, set-up {setup_s:.3f} s", file=sys.stderr, flush=True)
    measured = window.run(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    written = ranks.write_bytes() if world is not None else None
    if profiler is not None:
        profiler.stop()
    exact = window.finish()
    if trace:
        tracing.disable()
    blocked1 = goodput.snapshot()["by_mode"]
    blocked = {m: blocked1.get(m, 0.0) - blocked0.get(m, 0.0) for m in blocked1}
    losses = window.losses
    nonfinite = sum(not math.isfinite(x) for x in losses)

    everyone: List[Dict[str, Any]] = []
    if world is not None:
        inputs = job.reference_inputs()  # a collective: every rank's batches
        mine = {"rank": world.rank, "peak": peak, "exact": exact, "cycles": measured["ops"],
                "steps": measured["steps"], "state_bytes": state_bytes,
                "save_stall_s": save_stall_s.read(tracer.Context(job=None, window={}, spans=rec.spans, drains=[])),
                "window_write_bytes": None if written is None or written0 is None else written - written0,
                "lockstep_s": world.lockstep_s, "lockstep_calls": world.lockstep_calls}
        gathered = world.gather(mine)
        if gathered is None:  # another rank's part ends here
            return None
        everyone = gathered
        print("ranks: " + json.dumps(everyone), file=sys.stderr, flush=True)
        print(f"manifest: {_shard_census(manager)}", file=sys.stderr, flush=True)
        if cuda:
            peak = max(r["peak"] for r in everyone)
        exact = {k: sum(r["exact"][k] for r in everyone) for k in exact}
        exact["ranks_cycles_differ"] = sum(r["cycles"] != measured["ops"] for r in everyone)

    metrics: Dict[str, Dict[str, Any]] = {}
    device_block: Dict[str, Any] = {
        "platform": "gpu" if cuda else device,
        "kind": torch.cuda.get_device_name(0) if cuda else device,
        "count": int(cell["chips"]),
        "memory_peak_bytes": peak,
    }
    breakdown = ctx = None
    if not trace:
        e2e = {
            "step_s": measured["window_s"] / measured["steps"],
            "peak_card_GB": None if peak is None else peak / 1e9,
            "setup_s": setup_s,
        }
        for m in resolved["end_to_end"]:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        events = profiler.export(out_dir / f"{name}.trace.json")
        device_events, annotations = tracer.split_device_events(events)
        del events
        ctx = tracer.Context(
            job=job, window=dict(measured, profiled_cycles=window.profiled_cycles),
            spans=rec.spans, drains=[(w.returned, w.done_at) for w in getattr(window.op, "drains", [])],
            port_spans=tracer.read_port_spans(spans_path) if spans_path.exists() else [],
            restore_reports=getattr(window.op, "restore_reports", []),
            device_events=device_events, annotations=annotations, ranks=everyone)
        for m in resolved["per_layer"]:
            value = resolved["readers"][m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        found = tracer.busy_and_window(ctx)
        if found is not None:
            device_block["busy_s"], device_block["window_s"] = found
        breakdown = tracer.breakdown(ctx)
        copies: Dict[str, List[float]] = {}
        for e in ctx.device_in_window(("gpu_memcpy", "gpu_memset")):
            entry = copies.setdefault(e["name"], [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += float(e.get("args", {}).get("bytes", 0))
            entry[2] += e["dur"] / 1e6
        print(f"profiled copies (count, bytes, device s): {json.dumps(copies)}", file=sys.stderr)
        spans: Dict[str, float] = {}
        for s in rec.spans:
            if s["name"] not in ("cycle", "step"):
                spans[s["name"]] = spans.get(s["name"], 0.0) + s["t1"] - s["t0"]
        print(f"goodput blocked s {json.dumps(blocked)}; benchmark spans s {json.dumps(spans)}",
              file=sys.stderr, flush=True)

    ops = [s for s in rec.spans if s["name"] not in ("cycle", "step", cycles.CHECK_SPAN)]
    print("cycles s: " + json.dumps([round(s["t1"] - s["t0"], 4) for s in rec.spans if s["name"] == "cycle"])
          + "; checkpoint calls s: " + json.dumps([[s["name"], round(s["t1"] - s["t0"], 4)] for s in ops])
          + f"; checks left out of the window s: {measured['checks_s']:.4f}",
          file=sys.stderr, flush=True)
    if world is None:
        inputs = job.reference_inputs()
    reference_module = job.reference
    del job, window, manager, rec, profiler, ctx
    _drop_store(base)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_reference = time.monotonic()
    reference = reference_module.first_steps(config, weight_seed, inputs, CHECKED_STEPS, device)
    print(f"reference s: {time.monotonic() - t_reference:.3f}", file=sys.stderr, flush=True)
    numbers = checks.step_gaps(program, reference)
    limits = dict(config["limits"], **traffic.get("limits", {}))
    numbers["nonfinite_losses"], limits["nonfinite_losses"] = nonfinite, 0
    for check, count in exact.items():
        numbers[check], limits[check] = count, 0
    table = checks.verdict(numbers, limits)

    result: Dict[str, Any] = {
        "correct": checks.passed(table),
        "attempted": measured["steps"] + measured["ops"],
        "failed": nonfinite,
        "metrics": metrics,
        "device": device_block,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result


def parse(argv: List[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank of a cell of more than one chip, started by rank 0 (ranks.py).
    for hidden, kind in (("--rank", int), ("--world", int), ("--master-port", int), ("--store-dir", str)):
        parser.add_argument(hidden, type=kind, default=None, help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    problems = guard.check("at start")
    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 3
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    resolved = resolve(spec, args.workload)
    return run(resolved, args, t0, "cuda", [sys.executable, str(PACKAGE / "run.py"), *argv])


def run(resolved: Dict[str, Any], args: argparse.Namespace, t0: float, device: str,
        command: List[str], out_dir: Path = OUT_DIR) -> int:
    """One run of a resolved cell on ``device``; ``command`` starts this
    same run again as another rank. Rank 0 (or the only process) prints the
    line; returns the exit code."""
    chips = int(resolved["cell"]["chips"])
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if "layout" not in resolved["traffic"]:
        result = run_cell(resolved, args.seed, args.seconds, bool(args.trace), device, t0, out_dir)
    else:
        try:
            world = ranks.start(args.rank, chips, args.master_port, args.store_dir, command,
                                resolved["traffic"]["storage"], resolved["cell"]["name"],
                                resolved["family"].state_bytes(resolved["config"]), device)
        except ranks.NoResult as e:
            print(f"no result: {e}", file=sys.stderr)
            return 3
        try:
            result = run_cell(resolved, args.seed, args.seconds, bool(args.trace), device, t0, out_dir, world)
        except Exception as e:
            traceback.print_exc()
            print(f"no result: {world.failure(e)}", file=sys.stderr, flush=True)
            world.close(leave_group=False)
            return 4
        world.close()
        if result is None:
            return 0
    problems = guard.check("after the window")
    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 3
    for check, entry in result["checks"].items():
        print(f"check {check}: {entry['value']!r} (limit {entry['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
