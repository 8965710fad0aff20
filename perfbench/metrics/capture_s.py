"""capture_s: mean seconds of the program's ``Snapshot.async_take`` span, the
foreground of an async take (the cut and the drain's start)."""


def read(ctx):
    spans = [s["t1"] - s["t0"] for s in ctx.port_spans if s["name"] == "Snapshot.async_take"]
    return sum(spans) / len(spans) if spans else None
