"""pool_wait_s: mean thread-seconds a restore waited for a staging-pool
buffer, from each restore's ``_last_restore_report``."""


def read(ctx):
    reports = [r for r in ctx.restore_reports if r]
    if not reports:
        return None
    waits = [r.get("substeps", {}).get("pool_wait", {}).get("seconds", 0.0) for r in reports]
    return sum(waits) / len(waits)
