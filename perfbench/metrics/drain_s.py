"""drain_s: mean host seconds from an async_save's return to its drain's
commit (the pending snapshot done), over the saves whose end was seen."""


def read(ctx):
    spans = [done - returned for returned, done in ctx.drains if done is not None]
    return sum(spans) / len(spans) if spans else None
