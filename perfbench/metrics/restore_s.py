"""restore_s: mean host seconds of the window's restore calls."""


def read(ctx):
    spans = ctx.named("restore")
    return sum(s["t1"] - s["t0"] for s in spans) / len(spans) if spans else None
