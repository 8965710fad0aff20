"""The tracer's clock on the card: each ``d2h`` span of an async take holds
its device-to-host copy in ``torch.profiler``'s trace, the span put on the
profiler's clock as ``clock_epoch_s*1e6 + ts - baseTimeNanoseconds/1e3``,
within 1 ms at each end. Marked ``cuda``; skips without a CUDA device. On
the card (``--noconftest``: the suite's conftest.py sets up JAX, which this
file does not need)::

    python -m pytest --noconftest tests/test_torch_trace_spans_cuda.py -q -s
"""

import json

import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, tracing

pytestmark = pytest.mark.cuda

# Leaves of distinct sizes under the D2H chunk (64 MiB): one copy each, and
# each copy's bytes name its span.
LEAF_MIB = (2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32)
TOLERANCE_US = 1000.0


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def test_d2h_spans_hold_their_copies_on_the_profiler_clock(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    state = {"m": StateDict(**{f"w{i}": torch.randn(mib << 18, device="cuda")
                               for i, mib in enumerate(LEAF_MIB)})}
    torch.cuda.synchronize()
    spans_path, prof_path = tmp_path / "spans.json", tmp_path / "prof.json"
    tracing.enable(str(spans_path))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            Snapshot.async_take(str(tmp_path / "snap"), state).wait()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(prof_path))
    finally:
        tracing.disable()
    with open(prof_path) as f:
        prof_doc = json.load(f)
    base_us = int(prof_doc["baseTimeNanoseconds"]) / 1e3
    copies = {}
    for e in prof_doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy" and "DtoH" in str(e.get("name")):
            copies.setdefault(int(e["args"]["bytes"]), []).append(e)
    with open(spans_path) as f:
        doc = json.load(f)
    epoch_us = doc["metadata"]["clock_epoch_s"] * 1e6
    begins = {e["id"]: e for e in doc["traceEvents"] if e.get("ph") == "b" and e["name"] == "d2h"}
    ends = {e["id"]: e for e in doc["traceEvents"] if e.get("ph") == "e" and e["name"] == "d2h"}
    assert len(begins) == len(LEAF_MIB)
    # Each d2h span holds one d2h.pin span, the pinned buffer's allocation.
    pins = [e for e in doc["traceEvents"] if e.get("ph") == "b" and e["name"] == "d2h.pin"]
    assert sorted(e["parent"] for e in pins) == sorted(begins)
    offsets = []
    for i, b in begins.items():
        nbytes = b["args"]["bytes"]
        assert len(copies.get(nbytes, [])) == 1, (nbytes, sorted(copies))
        copy = copies[nbytes][0]
        a_us = epoch_us + b["ts"] - base_us
        b_us = epoch_us + ends[i]["ts"] - base_us
        # Slack at each end: the span should begin before the copy and end
        # after it; a clock error shows as a negative slack.
        offsets.append({"bytes": nbytes, "start_slack_us": copy["ts"] - a_us,
                        "end_slack_us": b_us - (copy["ts"] + copy["dur"]),
                        "copy_us": copy["dur"], "span_us": b_us - a_us})
    worst = min(min(o["start_slack_us"], o["end_slack_us"]) for o in offsets)
    print("d2h_clock " + json.dumps({
        "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "worst_slack_us": worst,
        "max_end_slack_us": max(o["end_slack_us"] for o in offsets),
        "spans": offsets}))
    assert worst >= -TOLERANCE_US, offsets
