"""The readings that the limits of ``correct`` are set from, at a cell's size.

    python3 perfbench/calibrate.py --config gpt2-xl --seeds 1001 1012 --control-seeds 3
    python3 perfbench/calibrate.py --config gpt2-xl --seeds 1001 1012 --extra-seeds 783805192

For each ``--extra-seeds`` seed (a run's seed to look into again; one given
twice is read twice) and then each seed of the range, in one process on the
card: the program's first steps (the same set-up code a run drives,
``harness._first_steps``) against the plain reference, as the run compares
them. Each reading names the three leaves that set each gap of norms, by the
check's own measure. For the first ``--control-seeds`` seeds also:

- the control: the reference in TF32 (the precision below the configured
  float32) in the program's place;
- the fault "half of the batch left out, the mean taken over the rest": the
  reference trained on the first half of each batch in the program's place;
- the fault "a step that returns its state unchanged", worked out without a
  run (every norm 0, the first loss repeated).

One JSON line per reading on standard output. This is not part of a
benchmark run; PERF.md gives the readings and the limits set from them.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    from perfbench import checks, harness

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--seeds", type=int, nargs=2, required=True, help="first and last seed")
    parser.add_argument("--extra-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}[args.config]
    config = json.loads((ROOT / entry["file"]).read_text())
    family = __import__(f"perfbench.families.{config['family']}", fromlist=["Job"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def emit(seed, kind, readings, reference, t0):
        gaps = checks.step_gaps(readings, reference)
        median = statistics.median(reference["grad1"])
        keep = [g >= 1e-3 * median for g in reference["grad1"]]
        worst = {}
        for key in ("grad1", "change"):
            ref = reference[key]
            mid = statistics.median(r for r, k in zip(ref, keep) if k)
            gap = [abs(p - r) / max(r, mid) if k else 0.0 for p, r, k in zip(readings[key], ref, keep)]
            top = sorted(range(len(gap)), key=gap.__getitem__, reverse=True)[:3]
            worst[key] = [{"leaf": i, "shape": shapes[i], "reference": ref[i], "program": readings[key][i],
                           "median": mid, "gap": gap[i]} for i in top]
        print(json.dumps(dict(config=args.config, seed=seed, kind=kind, seconds=time.monotonic() - t0, **gaps,
                              worst=worst, excluded_leaves=len(keep) - sum(keep))), flush=True)

    seeds = list(args.extra_seeds) + list(range(args.seeds[0], args.seeds[1] + 1))
    for index, seed in enumerate(seeds):
        ws, bs = harness.derive_seed(seed, "weights"), harness.derive_seed(seed, "batches")
        t0 = time.monotonic()
        job = family.Job(config, ws, bs, "cuda")
        shapes = [list(t.shape) for t in job.param_tensors()]
        program = harness._first_steps(job)
        inputs = job.reference_inputs()
        reference = job.reference
        del job
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        ref = reference.first_steps(config, ws, inputs, harness.CHECKED_STEPS, "cuda")
        emit(seed, "program", program, ref, t0)
        print(json.dumps({"seed": seed, "program_s": t1 - t0, "reference_s": time.monotonic() - t1,
                          "losses": ref["losses"], "peak_GB": torch.cuda.max_memory_allocated() / 1e9}),
              flush=True)
        if index < args.control_seeds:
            t0 = time.monotonic()
            emit(seed, "control_tf32", reference.first_steps(config, ws, inputs, harness.CHECKED_STEPS, "cuda",
                                                              tf32=True), ref, t0)
            t0 = time.monotonic()
            half = reference.dims(config)["batch"] // 2
            emit(seed, "fault_half_batch", reference.first_steps(config, ws, inputs, harness.CHECKED_STEPS, "cuda",
                                                                  rows=half), ref, t0)
            unchanged = {"losses": [ref["losses"][0]] * len(ref["losses"]),
                         "grad1": [0.0] * len(ref["grad1"]), "change": [0.0] * len(ref["change"])}
            emit(seed, "fault_state_unchanged", unchanged, ref, time.monotonic())
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
