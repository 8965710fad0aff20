"""finalize_s: a cycle's mean seconds in the program's
``CheckpointManager.finalize`` span (the step marker, the barrier and the
prune), over the async takes traced: each cycle's wait finalizes the take
before it, and the last take is finalized after the window, so its finalize
is left out. The base is ``save_stall_s``'s, which these seconds are part of."""


def read(ctx):
    takes = sorted((s["t0"], s["args"].get("trace")) for s in ctx.port_spans
                   if s["name"] == "Snapshot.async_take")
    if not takes:
        return None
    last = takes[-1][1]
    held = sum(s["t1"] - s["t0"] for s in ctx.port_spans
               if s["name"] == "CheckpointManager.finalize" and s["args"].get("trace") != last
               and str(s["args"].get("trace")).startswith("async_take-"))
    return held / len(takes)
