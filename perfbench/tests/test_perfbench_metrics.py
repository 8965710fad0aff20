"""Each per-layer metric reader on a small recorded event list."""

import importlib

import pytest

from perfbench import harness, program_trace, roofline, tracer
from perfbench.tests import test_perfbench_program_spans as program_spans
from perfbench.tests.toy import SPEC


class FakeJob:
    def __init__(self, flops=None, shape=None):
        self._flops, self._shape = flops, shape

    def flops_per_step(self):
        return self._flops

    def attention_shape(self):
        return self._shape


def span(name, t0, t1, cycle=0):
    return {"name": name, "t0": t0, "t1": t1, "cycle": cycle}


def device(name, cat, ts, dur, nbytes=None):
    e = {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}
    if nbytes is not None:
        e["args"] = {"bytes": nbytes}
    return e


def note(name, ts, dur):
    return {"name": "perfbench." + name, "cat": "user_annotation", "ts": ts, "dur": dur, "ph": "X"}


SHAPE = (4, 25, 1024, 64)
FWD = roofline.FLASH_KERNELS["flash_fwd_kernel"](*SHAPE)


def context(**kw):
    spans = [span("cycle", 0.0, 10.0), span("step", 0.0, 1.0), span("step", 1.0, 2.0), span("step", 2.0, 4.0),
             span("wait_prev", 4.0, 4.5), span("async_save", 4.5, 4.6), span("restore", 4.6, 6.0),
             span("step", 6.0, 7.0)]
    events = [
        device("void (anonymous namespace)::flash_fwd_kernel<float, 64>(float const*)", "kernel", 100.0, 2 * FWD * 1e6),
        device("gemm", "kernel", 1000.0, 3000.0),
        device("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", "kernel", 4000.0, 400.0),
        device("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 5000.0, 1000.0, nbytes=20e6),
        device("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 7000.0, 500.0, nbytes=10e6),
        device("outside the window", "kernel", 20000.0, 100.0),
    ]
    notes = [note("cycle", 0.0, 10000.0), note("step", 0.0, 900.0), note("restore", 6000.0, 3000.0)]
    base = dict(job=FakeJob(4e13, SHAPE), window={"profiled_cycles": [0], "steps": 4, "window_s": 10.0},
                spans=spans,
                drains=[(4.6, 6.5)], port_spans=[
                    {"name": "stage", "t0": 1.0, "t1": 2.0, "args": {"trace": "a"}},
                    {"name": "stage", "t0": 1.5, "t1": 3.0, "args": {"trace": "a"}},
                    {"name": "stage", "t0": 5.0, "t1": 6.0, "args": {"trace": "b"}},
                    {"name": "write", "t0": 0.0, "t1": 9.0, "args": {"trace": "b"}}],
                restore_reports=[{"substeps": {"pool_wait": {"seconds": 3.0}}}, {"substeps": {}}],
                device_events=events, annotations=notes,
                ranks=[{"save_stall_s": 0.6}, {"save_stall_s": 0.9}, {"save_stall_s": None}])
    base.update(kw)
    return tracer.Context(**base)


EXPECTED = {
    "quiet_step_s": (1.0 + 1.0 + 2.0) / 3,  # the 6-7 s step overlaps the restore and the drain
    "train_mfu": 100.0 * 4e13 * 4 / 10.0 / roofline.PEAK_F32_FLOPS,
    "attn_roofline": 50.0,
    "save_stall_s": 0.6,
    "restore_s": 1.4,
    "drain_s": 1.9,
    "stage_busy_s": (2.0 + 1.0) / 2,
    "pool_wait_s": 1.5,
    "d2h_GBps": 20.0,
    "h2d_GBps": 20.0,
    "device_idle": 100.0 * (1 - (2 * FWD * 1e6 + 3000 + 400 + 1000 + 500) / 10000.0),
    "save_stall_max_s": 0.9,  # the slowest rank's; a rank without a reading is passed over
    "collective_s": 0.0004 / 4,  # one NCCL kernel of 0.4 ms over the profiled cycle's 4 steps
    # The program's own spans: read from a traced run's two files.
    **program_spans.EXPECTED,
}


def test_every_benchmark_metric_is_covered():
    assert {m["name"] for m in SPEC["per_layer"]} == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_recorded_events(name, tmp_path, monkeypatch):
    if name in program_spans.EXPECTED:
        monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
        ctx = program_trace.context_from_files(*program_spans.write_traces(tmp_path))
    else:
        ctx = context()
    reader = importlib.import_module(f"perfbench.metrics.{name}")
    assert reader.read(ctx) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_none(name):
    empty = tracer.Context(job=FakeJob(), window={}, spans=[], drains=[])
    assert importlib.import_module(f"perfbench.metrics.{name}").read(empty) is None


def test_breakdown_and_busy():
    ctx = context()
    busy, window = tracer.busy_and_window(ctx)
    assert window == pytest.approx(0.01) and busy == pytest.approx((2 * FWD * 1e6 + 4900) / 1e6)
    out = tracer.breakdown(ctx)
    assert out["device_ops"][0][0] == "gemm" and len(out["idle_gaps"]) <= 10
    # The longest gap (7.5 ms to 10 ms) lies inside the restore annotation.
    assert out["idle_gaps"][0] == ["perfbench.restore", pytest.approx(0.0025)]
