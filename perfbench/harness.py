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
  and call keyword arguments on as they are;
- each per-layer metric is ``perfbench/metrics/<name>.py``.

An unknown name fails the run before any work.
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
from pathlib import Path
from typing import Any, Dict, List

import torch

from perfbench import checks, cycles, guard, tracer

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
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in spec["end_to_end"] if _applies(m, workload)],
        "per_layer": per_layer,
        "family": importlib.import_module(f"perfbench.families.{config['family']}"),
        "readers": {m["name"]: _reader(m["name"]) for m in per_layer},
    }


def _reader(name: str) -> Any:
    """``perfbench/metrics/<name>.py``."""
    module = importlib.import_module(f"perfbench.metrics.{name}")
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"perfbench/metrics/{name}.py has no read(ctx)")
    return module


def _store(traffic: Dict[str, Any], name: str, seed: int) -> str:
    """The manager's base path for the mix's storage, new for this run."""
    if traffic["storage"] == "fs":
        return tempfile.mkdtemp(prefix=f"perfbench-{name}-")
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
    change = [float((p.double() - q.double()).norm()) for p, q in zip(job.param_tensors(), start)]
    del start
    return {"losses": losses, "grad1": grad1, "change": change}


def run_cell(resolved: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str,
             t0: float, out_dir: Path = OUT_DIR) -> Dict[str, Any]:
    """Set-up, window, checks; the result line as a dict."""
    from torchsnapshot_tpu_torch import tracing
    from torchsnapshot_tpu_torch.manager import CheckpointManager
    from torchsnapshot_tpu_torch.telemetry import goodput

    cell, config, traffic = resolved["cell"], resolved["config"], resolved["traffic"]
    name = cell["name"]
    cuda = device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weight_seed, batch_seed = derive_seed(seed, "weights"), derive_seed(seed, "batches")

    job = resolved["family"].Job(config, weight_seed, batch_seed, device)
    state_bytes = sum(t.numel() * t.element_size() for t in job.state_tensors())
    print(_host_memory_line(state_bytes), file=sys.stderr, flush=True)
    if cuda:
        print(_card_line(), file=sys.stderr, flush=True)
    program = _first_steps(job)

    base = _store(traffic, name, seed)
    manager = CheckpointManager(base, **traffic["manager"])
    rec = cycles.Recorder(annotate=trace)
    profiler = tracer.Profiler(cuda) if trace else None
    window = cycles.Window(job, manager, traffic, rec, watch_drains=trace, profiler=profiler)
    window.prepare()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans_path = out_dir / f"{name}.spans.json"
    if trace:
        out_dir.mkdir(parents=True, exist_ok=True)
        tracing.enable(str(spans_path))
    blocked0 = goodput.snapshot()["by_mode"]
    setup_s = time.monotonic() - t0

    measured = window.run(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if profiler is not None:
        profiler.stop()
    exact = window.finish()
    if trace:
        tracing.disable()
    blocked1 = goodput.snapshot()["by_mode"]
    blocked = {m: blocked1.get(m, 0.0) - blocked0.get(m, 0.0) for m in blocked1}
    losses = window.losses
    nonfinite = sum(not math.isfinite(x) for x in losses)

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
            device_events=device_events, annotations=annotations)
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
    inputs = job.reference_inputs()
    reference_module = job.reference
    del job, window, manager, rec, profiler, ctx
    _drop_store(base)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = reference_module.first_steps(config, weight_seed, inputs, CHECKED_STEPS, device)
    numbers = checks.step_gaps(program, reference)
    limits = dict(config["limits"])
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


def main(argv: List[str], t0: float) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    problems = guard.check("at start")
    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 3
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    resolved = resolve(spec, args.workload)
    chips = int(resolved["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(resolved, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    problems = guard.check("after the window")
    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 3
    for check, entry in result["checks"].items():
        print(f"check {check}: {entry['value']!r} (limit {entry['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
