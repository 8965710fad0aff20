"""save_stall_s: mean host seconds a cycle's checkpoint blocks the loop, the
wait on the previous save plus the async_save call."""


def read(ctx):
    stall = {}
    for s in ctx.spans:
        if s["name"] in ("wait_prev", "async_save"):
            stall[s["cycle"]] = stall.get(s["cycle"], 0.0) + s["t1"] - s["t0"]
    return sum(stall.values()) / len(stall) if stall else None
