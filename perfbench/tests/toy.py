"""Cells of BENCHMARK.json at toy sizes, run on the CPU."""

import json
import time
from pathlib import Path

from perfbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
# Cells of one chip run in the test's process; the others a rank per
# process over gloo (``rank_entry.py``), in a world of TOY_WORLD.
ONE_CARD = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]
RANKED = [w["name"] for w in SPEC["workloads"] if w["chips"] > 1]
TOY_WORLD = 2

TOY = {
    "transformer": dict(vocab_size=97, n_embd=64, n_head=4, n_layer=2, n_positions=32,
                        batch_size=4, seq_len=32, attention="einsum"),
    "dlrm": dict(num_embeddings_per_feature=[50, 7, 300, 3], arch_mlp_bot="13-32-16",
                 arch_mlp_top="32-1", mini_batch_size=16),
}


def resolved(cell: str, steps_per_cycle: int = 3) -> dict:
    """The cell with its configuration cut to a toy size and short cycles."""
    r = harness.resolve(SPEC, cell)
    r["config"].update(TOY[r["config"]["family"]])
    if r["cell"]["chips"] > 1:
        r["cell"] = dict(r["cell"], chips=TOY_WORLD)
    r["traffic"] = dict(r["traffic"], steps_per_cycle=min(r["traffic"]["steps_per_cycle"], steps_per_cycle))
    return r


def run(cell: str, tmp: Path, trace: bool = False, seconds: float = 1.0, seed: int = 4_000_000_001) -> dict:
    return harness.run_cell(resolved(cell), seed, seconds, trace, "cpu", time.monotonic(), out_dir=tmp)
