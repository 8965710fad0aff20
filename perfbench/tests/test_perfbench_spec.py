"""BENCHMARK.json against the benchmark's contract, and every entry found by name."""

import json
import re
import subprocess
import sys

import pytest

from perfbench import cycles, harness
from perfbench.tests.toy import CELLS, SPEC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # A full check of 24 cells fits the check's time: 2 + 14 runs a cell.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24


def test_names_units_and_metrics():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["moves"] in E2E and set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    """Config file, traffic file, family module and every metric reader load
    by the names BENCHMARK.json gives; the cell reports setup_s, another
    end-to-end metric and a per-layer metric that moves one it reports."""
    entry = {w["name"]: w for w in SPEC["workloads"]}[cell]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    resolved = harness.resolve(SPEC, cell)
    reported = {m["name"] for m in resolved["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert resolved["per_layer"] and all(m["moves"] in reported for m in resolved["per_layer"])
    assert set(resolved["readers"]) == {m["name"] for m in resolved["per_layer"]}
    assert hasattr(resolved["family"], "Job") and hasattr(resolved["family"].Job, "reference")
    config_entry = {c["name"]: c for c in SPEC["configs"]}[entry["config"]]
    assert config_entry["file"].startswith("perfbench/configs/")
    assert set(config_entry["reduced"]) == set(resolved["config"]["reduced"])


def test_unknown_names_fail_loudly():
    with pytest.raises(KeyError):
        harness.resolve(SPEC, "no.such_cell")
    bad = json.loads(json.dumps(SPEC))
    bad["workloads"][0]["traffic"] = "no_such_mix"
    with pytest.raises(FileNotFoundError):
        harness.resolve(bad, bad["workloads"][0]["name"])
    mix = {"operation": "async_save", "steps_per_cycle": 1, "trace_cycles": 1, "storage": "memory",
           "manager": {}, "call": {}}
    cycles.validate(mix)
    with pytest.raises(ModuleNotFoundError):
        cycles.validate(dict(mix, operation="no_such_operation"))
    with pytest.raises(ValueError):
        cycles.validate(dict(mix, storage="s3"))
    with pytest.raises(ValueError):
        cycles.validate(dict(mix, call=["stage"]))
    bad = json.loads(json.dumps(SPEC))
    bad["per_layer"].append(dict(bad["per_layer"][0], name="no_such_metric", workloads=[CELLS[0]]))
    with pytest.raises(ModuleNotFoundError):
        harness.resolve(bad, CELLS[0])


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "5000000000", "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_without_the_program_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and perfbench/ has no program
    to measure: the run exits non-zero and prints no result."""
    (tmp_path / "BENCHMARK.json").write_text((harness.ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(harness.PACKAGE), str(tmp_path / "perfbench")], check=True)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "torchsnapshot_tpu_torch" in proc.stderr
