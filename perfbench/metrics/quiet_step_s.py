"""quiet_step_s: mean host seconds of the window's training steps that
overlap no checkpoint call, wait, drain or check of the benchmark's (each
step ends in a sync)."""

# Spans that are not checkpoint work: every other span blocks the loop.
OWN = ("cycle", "step")


def read(ctx):
    blocked = [(s["t0"], s["t1"]) for s in ctx.spans if s["name"] not in OWN]
    blocked += [(returned, done) for returned, done in ctx.drains if done is not None]
    if any(done is None for _, done in ctx.drains):
        return None  # a drain whose end was not seen: no step is known quiet
    quiet = [s["t1"] - s["t0"] for s in ctx.named("step")
             if not any(a < s["t1"] and s["t0"] < b for a, b in blocked)]
    return sum(quiet) / len(quiet) if quiet else None
