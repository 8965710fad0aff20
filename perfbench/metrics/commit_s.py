"""commit_s: per async take (a trace id with a ``drain`` span), the seconds
of its drain's ``phase.commit`` spans, averaged over the takes traced."""


def read(ctx):
    drained = {s["args"].get("trace") for s in ctx.port_spans if s["name"] == "drain"}
    takes = {}
    for s in ctx.port_spans:
        trace = s["args"].get("trace")
        if s["name"] == "phase.commit" and trace in drained and trace is not None:
            takes[trace] = takes.get(trace, 0.0) + s["t1"] - s["t0"]
    return sum(takes.values()) / len(takes) if takes else None
