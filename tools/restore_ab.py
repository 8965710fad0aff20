#!/usr/bin/env python3
"""Restore of the GPT-2-XL-width state by two checkouts, in turns, on one card.

    python3 tools/restore_ab.py --other build/parent [--order other,this,this,other] [--repeat N]
                                [--verify-device]
    python3 tools/restore_ab.py --summarize LOG

Takes the flagship transformer at GPT-2 XL widths (6.23 GB, seed 0) once
with this checkout into a scratch directory, then restores it into a
model of other values (seed 1) on the card in a fresh process per turn,
each turn importing ``torchsnapshot_tpu_torch`` from this checkout or
from ``--other`` (an unpacked ``git archive`` of another commit). Each
turn prints one JSON line: the checkout, the restore's seconds and GB/s
(until the last byte has landed) and whether every leaf is byte-equal.
``--repeat N`` runs the order N times over. ``--verify-device`` takes
with fingerprints and restores with ``verify_device=True`` (K4 over
every restored leaf). Then, for each checkout, the
median, quartiles, least and most of its seconds and its median GB/s,
and the pairs (turns 2k and 2k+1) the checkout won; the filesystem's
read rate of the same run and the card's name and power limit.
``--summarize LOG`` prints the same summary from the turn lines of a
saved run's output, with no card.
"""

import argparse
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.models import transformer as tf
cfg = tf.TransformerConfig(vocab_size=50257, d_model=1600, n_heads=25, n_layers=48,
                           d_ff=6400, max_seq_len=1024, dtype=torch.float32)
want = list(tf.param_leaves(tf.init_params(cfg, seed=0)))
model = tf.Transformer.init(cfg, seed=1)
torch.cuda.synchronize()
begin = time.perf_counter()
Snapshot(sys.argv[2]).restore({"model": tf.TransformerState(model)}, verify_device=sys.argv[3] == "1")
torch.cuda.synchronize()
seconds = time.perf_counter() - begin
equal = all(torch.equal(a.view(torch.uint8), b.detach().view(torch.uint8))
            for a, b in zip(want, tf.param_leaves(model.params())))
nbytes = sum(t.numel() * t.element_size() for t in want)
print(json.dumps({"restore_s": seconds, "gbps": nbytes / 1e9 / seconds, "equal": equal}))
"""


def summarize(results):
    """Per checkout: median, quartiles, least and most seconds, median
    GB/s, and the pairs of consecutive turns (0-1, 2-3, ...) it won."""
    pairs = [(a, b) for a, b in zip(results[::2], results[1::2]) if a["checkout"] != b["checkout"]]
    for name in ("other", "this"):
        secs = [r["restore_s"] for r in results if r["checkout"] == name]
        if len(secs) < 2:
            continue
        q1, _, q3 = statistics.quantiles(secs, n=4)
        won = sum(1 for a, b in pairs
                  if min((a, b), key=lambda r: r["restore_s"])["checkout"] == name)
        print(json.dumps({"summary": name, "turns": len(secs),
                          "median_s": statistics.median(secs), "q1_s": q1, "q3_s": q3,
                          "min_s": min(secs), "max_s": max(secs),
                          "median_gbps": statistics.median(
                              r["gbps"] for r in results if r["checkout"] == name),
                          "pairs_won": won, "pairs": len(pairs)}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--other")
    group.add_argument("--summarize", metavar="LOG")
    parser.add_argument("--order", default="other,this,this,other")
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--verify-device", action="store_true")
    args = parser.parse_args()
    if args.summarize:
        with open(args.summarize) as f:
            records = [json.loads(line) for line in f if line.startswith('{"checkout"')]
        summarize(records)
        return 0
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("restore_ab.py needs a CUDA device.", file=sys.stderr)
        return 2
    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.models import transformer as tf

    checkouts = {"this": ROOT, "other": os.path.abspath(args.other)}
    workdir = tempfile.mkdtemp(prefix="restore_ab-")
    try:
        cfg = tf.TransformerConfig(vocab_size=50257, d_model=1600, n_heads=25, n_layers=48,
                                   d_ff=6400, max_seq_len=1024, dtype=torch.float32)
        path = os.path.join(workdir, "snap")
        model = tf.Transformer.init(cfg, seed=0)
        Snapshot.take(path, {"model": tf.TransformerState(model)}, fingerprint=args.verify_device)
        del model
        torch.cuda.empty_cache()
        results = []
        for name in args.order.split(",") * args.repeat:
            proc = subprocess.run([sys.executable, "-c", TURN, checkouts[name], path,
                                   "1" if args.verify_device else "0"],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stderr, file=sys.stderr)
                return 1
            record = {"checkout": name, **json.loads(proc.stdout.strip().splitlines()[-1])}
            results.append(record)
            print(json.dumps(record), flush=True)
        summarize(results)
        files = [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs]
        begin = time.perf_counter()
        total = 0
        for name in files:
            with open(name, "rb") as f:
                total += len(f.read())
        print(json.dumps({"fs_read_serial_gbps": total / 1e9 / (time.perf_counter() - begin)}))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0 if all(r["equal"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
