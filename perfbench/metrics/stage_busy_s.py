"""stage_busy_s: per async take, the union of the program's ``stage`` spans
(scheduler.py), averaged over the takes traced."""

from perfbench.tracer import union_seconds


def read(ctx):
    takes = {}
    for s in ctx.port_spans:
        if s["name"] == "stage":
            takes.setdefault(s["args"].get("trace"), []).append((s["t0"], s["t1"]))
    takes.pop(None, None)
    if not takes:
        return None
    return sum(union_seconds(v) for v in takes.values()) / len(takes)
