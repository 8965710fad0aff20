"""A cell of more than one chip at a toy size on the CPU: a rank per process
over gloo, started by rank 0 through ``harness.run`` and ``perfbench/ranks.py``
(``rank_entry.py`` in ``run.py``'s place), with the store in ``/dev/shm``.
The one-card cells still resolve as they did before ranks existed."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import harness, ranks
from perfbench.tests import toy

CELL = toy.RANKED[0]
# Seconds a toy run of two ranks may take, set-up included.
LIMIT_S = 240


def launch(seed, seconds=2.0, trace=0, **env):
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.tests.rank_entry", "--workload", CELL, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=harness.ROOT, env=dict(os.environ, **env), capture_output=True, text=True, timeout=LIMIT_S)
    proc.seconds = time.monotonic() - t0
    return proc


def result_of(proc):
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout  # only rank 0 prints, and only the line
    return json.loads(lines[0])


def line_after(stderr, prefix):
    [line] = [x for x in stderr.splitlines() if x.startswith(prefix)]
    return line[len(prefix):]


def store_dirs():
    return sorted(Path(ranks.SHM_ROOT).glob(f"perfbench-{CELL}-*"))


def processes_with(marker):
    """Process ids whose command line holds ``marker`` (a run's seed)."""
    found = []
    for proc in Path("/proc").iterdir():
        if proc.name.isdigit():
            try:
                cmd = (proc / "cmdline").read_bytes()
            except OSError:
                continue
            if b"rank_entry" in cmd and marker.encode() in cmd.split(b"\0"):
                found.append(int(proc.name))
    return found


@pytest.fixture(scope="module")
def slow_rank():
    """Rank 1's steps each 20 ms slower than rank 0's."""
    before = store_dirs()
    proc = launch(4_000_000_101, PERFBENCH_TOY_RANK="1", PERFBENCH_TOY_SLOW_S="0.02")
    proc.left_behind = [d for d in store_dirs() if d not in before]
    return proc


def test_ranks_run_the_same_cycles_when_one_is_slower(slow_rank):
    result = result_of(slow_rank)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == toy.TOY_WORLD and list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"step_s", "setup_s"}  # no card: no peak_card_GB
    summaries = json.loads(line_after(slow_rank.stderr, "ranks: "))
    assert [s["rank"] for s in summaries] == list(range(toy.TOY_WORLD))
    assert len({s["cycles"] for s in summaries}) == 1 and len({s["steps"] for s in summaries}) == 1
    assert summaries[0]["cycles"] >= 2 and result["checks"]["ranks_cycles_differ"]["value"] == 0
    assert all(s["lockstep_calls"] == s["cycles"] for s in summaries)
    # The other rank writes to standard error only, each line marked.
    assert any(x.startswith("[rank 1] ") for x in slow_rank.stderr.splitlines())


def test_shm_store_holds_a_shard_from_every_rank(slow_rank):
    census = line_after(slow_rank.stderr, "manifest: ")
    leaves = len(list(toy.resolved(CELL)["family"].reference.leaf_shapes(
        toy.resolved(CELL)["family"].reference.dims(toy.resolved(CELL)["config"]))))
    assert census.startswith(f"sharded leaves {leaves}, shards per leaf {{\"{toy.TOY_WORLD}\": {leaves}}}")
    written = json.loads(census.split("payload bytes written by rank ")[1])
    assert sorted(written) == [str(r) for r in range(toy.TOY_WORLD)] and all(v > 0 for v in written.values())
    assert result_of(slow_rank)["checks"]["snapshot_leaves_differ"]["value"] == 0
    assert slow_rank.left_behind == []  # the store's directory is removed


def test_traced_run_reads_the_rank_metrics():
    result = result_of(launch(4_000_000_102, trace=1))
    assert result["correct"], result["checks"]
    per_layer = harness.resolve(toy.SPEC, CELL)["per_layer"]
    expected = {m["name"] for m in per_layer if m["source"] != "device_trace"}
    assert expected and expected <= set(result["metrics"])
    assert "collective_s" not in result["metrics"]  # no device trace on the CPU


@pytest.mark.parametrize("fault,rank,failing", [
    ("state_unchanged", None, {"loss_gap", "grad1_gap", "change3_gap"}),
    ("half_batch", None, {"loss_gap", "grad1_gap", "change3_gap"}),
    ("exchange_left_out", None, {"grad1_gap", "change3_gap"}),
    ("control_tf32", None, {"loss_gap", "grad1_gap", "change3_gap"}),
    ("altered_answer", "1", {"snapshot_leaves_differ"}),
    ("swapped_pieces", "1", {"snapshot_leaves_differ"}),
])
def test_broken_path_is_not_correct(fault, rank, failing):
    """Each fault the cell can have, planted under the timed path of every
    rank (or of rank 1 alone, for one rank's shard altered where the take
    captures it): ``correct`` comes out false on the numbers that see it."""
    env = {"PERFBENCH_TOY_FAULT": fault, **({"PERFBENCH_TOY_RANK": rank} if rank else {})}
    result = result_of(launch(4_000_000_110, seconds=1.0, **env))
    assert result["correct"] is False, result["checks"]
    seen = {name for name, e in result["checks"].items() if not e["value"] <= e["limit"]}
    assert seen & failing, result["checks"]


def test_a_rank_that_exits_early_ends_the_run():
    seed = "4000000120"
    before = store_dirs()
    proc = launch(int(seed), seconds=30.0, PERFBENCH_TOY_RANK="1", PERFBENCH_TOY_EXIT_AT="2")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no result: rank 1 exited with code 9" in proc.stderr
    assert proc.seconds < 60  # long before the 30 s window would have ended with its checks
    assert processes_with(seed) == [] and [d for d in store_dirs() if d not in before] == []


def test_shm_refuses_what_is_not_tmpfs_or_too_small(tmp_path):
    if ranks.tmpfs_mount(str(tmp_path)) != "tmpfs":
        with pytest.raises(ranks.NoResult, match="not tmpfs"):
            ranks.make_shm_dir("x", 1, root=str(tmp_path))
    assert ranks.tmpfs_mount(ranks.SHM_ROOT) == "tmpfs"
    with pytest.raises(ranks.NoResult, match="bytes free"):
        ranks.make_shm_dir("x", 1 << 60)
    with pytest.raises(ranks.NoResult):
        ranks.make_store_dir("memory", "x", 1)


# What each one-card cell resolved to before ranks existed: family module,
# configuration file, traffic mix and its content, limits.
ONE_CARD_AS_BEFORE = {
    "gpt2xl.train_async": ("transformer", "gpt2-xl", "async_every_4", ("async_save", 4)),
    "dlrm.train_resume": ("dlrm", "dlrm-criteo-kaggle", "resume_after_100", ("restore", 100)),
    "gpt2xl.train_resume": ("transformer", "gpt2-xl", "resume_after_4", ("restore", 4)),
    "dlrm.train_async": ("dlrm", "dlrm-criteo-kaggle", "async_every_100", ("async_save", 100)),
}
LIMITS_BEFORE = {
    "gpt2-xl": {"loss_gap": 3.5e-07, "grad1_gap": 0.005, "change3_gap": 0.005},
    "dlrm-criteo-kaggle": {"loss_gap": 3e-07, "grad1_gap": 0.0005, "change3_gap": 0.0005},
}


@pytest.mark.parametrize("cell", sorted(ONE_CARD_AS_BEFORE))
def test_one_card_cells_resolve_as_before(cell):
    family, config, traffic, (operation, steps) = ONE_CARD_AS_BEFORE[cell]
    r = harness.resolve(toy.SPEC, cell)
    entry = {c["name"]: c for c in toy.SPEC["configs"]}[r["cell"]["config"]]
    assert r["cell"]["chips"] == 1 and r["cell"]["config"] == config and r["cell"]["traffic"] == traffic
    assert r["family"].__name__ == f"perfbench.families.{family}"
    assert entry["file"] == f"perfbench/configs/{config}.json" and r["config"]["limits"] == LIMITS_BEFORE[config]
    assert r["traffic"] == {"operation": operation, "steps_per_cycle": steps, "storage": "memory",
                            "manager": {"max_to_keep": 1}, "call": {"stage": "auto"} if operation == "async_save"
                            else {}, "trace_cycles": 2}
