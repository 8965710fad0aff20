"""save_stall_max_s: with a rank per card, the largest over the ranks of
each rank's ``save_stall_s`` (its cycle mean of the wait on the previous
save plus the async_save call, on its own clock), gathered after the
window: the rank that sets the pace."""


def read(ctx):
    stalls = [r["save_stall_s"] for r in ctx.ranks if r.get("save_stall_s") is not None]
    return max(stalls) if stalls else None
