"""d2h_wait_s: per async take (a trace id with a ``drain`` span), the union
of its ``d2h`` spans (ops/transfer.py: a stager from its copy's enqueue to
the copy's end; none, and so 0, for a take of host tensors), averaged over
the takes traced."""

from perfbench.tracer import union_seconds


def read(ctx):
    takes = {s["args"].get("trace"): [] for s in ctx.port_spans if s["name"] == "drain"}
    takes.pop(None, None)
    for s in ctx.port_spans:
        if s["name"] == "d2h" and s["args"].get("trace") in takes:
            takes[s["args"]["trace"]].append((s["t0"], s["t1"]))
    return sum(union_seconds(v) for v in takes.values()) / len(takes) if takes else None
