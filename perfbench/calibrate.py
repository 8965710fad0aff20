"""The readings that the limits of ``correct`` are set from, at a cell's size.

    python3 perfbench/calibrate.py --config gpt2-xl --seeds 1001 1012 --control-seeds 3
    python3 perfbench/calibrate.py --config gpt2-xl --seeds 1001 1012 --extra-seeds 783805192
    python3 perfbench/calibrate.py --workload gpt2xl.fsdp4_async --seeds 1001 1012 --fault-seeds 3

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

With ``--workload`` of a cell laid out a rank per card, the cell's family
runs on as many cards as the cell asks for, a rank per card
(``perfbench/ranks.py``), each rank on the micro-batches of its run's batch
seed; rank 0 runs the reference over the global batch. For the first
``--fault-seeds`` seeds the program also runs with its gradients' exchange
left out (``perfbench/faults.py``'s ``exchange_left_out``, planted in every
rank).

One JSON line per reading on standard output (rank 0's). This is not part
of a benchmark run; PERF.md gives the readings and the limits set from them.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from perfbench import checks, harness, ranks

    t_start = time.monotonic()
    parser = argparse.ArgumentParser()
    which = parser.add_mutually_exclusive_group(required=True)
    which.add_argument("--config")
    which.add_argument("--workload")
    parser.add_argument("--seeds", type=int, nargs=2, required=True, help="first and last seed")
    parser.add_argument("--extra-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=0)
    for hidden, kind in (("--rank", int), ("--world", int), ("--master-port", int), ("--store-dir", str)):
        parser.add_argument(hidden, type=kind, default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    world = None
    if args.workload:
        resolved = harness.resolve(spec, args.workload)
        config, family = resolved["config"], resolved["family"]
        name = args.config = resolved["cell"]["config"]
        if "layout" in resolved["traffic"]:
            chips = int(resolved["cell"]["chips"])
            world = ranks.start(args.rank, chips, args.master_port, args.store_dir,
                                [sys.executable, sys.argv[0], *argv], None, args.workload, 0,
                                "cuda", setup_limit_s=3500.0)
    else:
        entry = {c["name"]: c for c in spec["configs"]}[args.config]
        config = json.loads((ROOT / entry["file"]).read_text())
        family = __import__(f"perfbench.families.{config['family']}", fromlist=["Job"])
        name = args.config
    lead = world is None or world.rank == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def emit(seed, kind, readings, reference, t0):
        if not lead:
            return
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
        print(json.dumps(dict(config=name, seed=seed, kind=kind, seconds=time.monotonic() - t0, **gaps,
                              worst=worst, excluded_leaves=len(keep) - sum(keep))), flush=True)

    def program_readings(seed):
        """The program's first steps for ``seed``, and the reference's inputs."""
        ws = harness.derive_seed(seed, "weights")
        bs = harness.derive_seed(seed, "batches" if world is None else f"batches.rank{world.rank}")
        job = family.Job(config, ws, bs, "cuda")
        readings = harness._first_steps(job)
        inputs = job.reference_inputs()
        del job
        torch.cuda.empty_cache()
        return readings, inputs

    reference = family.Job.reference
    shapes = [list(s) for s in reference.leaf_shapes(reference.dims(config))]
    seeds = list(args.extra_seeds) + list(range(args.seeds[0], args.seeds[1] + 1))
    for index, seed in enumerate(seeds):
        ws = harness.derive_seed(seed, "weights")
        t0 = time.monotonic()
        program, inputs = program_readings(seed)
        t1 = time.monotonic()
        if lead:
            ref = reference.first_steps(config, ws, inputs, harness.CHECKED_STEPS, "cuda")
            emit(seed, "program", program, ref, t0)
            print(json.dumps({"seed": seed, "program_s": t1 - t0, "reference_s": time.monotonic() - t1,
                              "losses": ref["losses"], "peak_GB": torch.cuda.max_memory_allocated() / 1e9}),
                  flush=True)
        if index < args.control_seeds and lead:
            t0 = time.monotonic()
            emit(seed, "control_tf32", reference.first_steps(config, ws, inputs, harness.CHECKED_STEPS, "cuda",
                                                              tf32=True), ref, t0)
            t0 = time.monotonic()
            half = inputs.shape[1] // 2
            emit(seed, "fault_half_batch", reference.first_steps(config, ws, inputs, harness.CHECKED_STEPS, "cuda",
                                                                  rows=half), ref, t0)
            unchanged = {"losses": [ref["losses"][0]] * len(ref["losses"]),
                         "grad1": [0.0] * len(ref["grad1"]), "change": [0.0] * len(ref["change"])}
            emit(seed, "fault_state_unchanged", unchanged, ref, time.monotonic())
        if index < args.fault_seeds and world is not None:
            from perfbench import faults

            with faults.planted("exchange_left_out"):
                t0 = time.monotonic()
                broken, _ = program_readings(seed)
            emit(seed, "fault_exchange_left_out", broken, ref if lead else None, t0)
        if world is not None:
            torch.distributed.barrier()
        torch.cuda.empty_cache()
    if world is not None:
        world.gather({})
        world.close()
    print(json.dumps({"calibrate_s": time.monotonic() - t_start}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
