"""Per-layer metric readers: ``perfbench/metrics/<metric>.py`` defines
``read(ctx) -> float | None`` over a ``tracer.Context``; None leaves the
metric out of the run's line."""


def copy_rate(ctx, kind):
    """GB/s of the profiled copies whose name holds ``kind`` (``HtoD``,
    ``DtoH``): their bytes over their device seconds."""
    nbytes = seconds = 0.0
    for e in ctx.device_in_window(("gpu_memcpy",)):
        if kind in str(e.get("name")):
            nbytes += float(e.get("args", {}).get("bytes", 0))
            seconds += e["dur"] / 1e6
    return nbytes / 1e9 / seconds if seconds > 0 and nbytes > 0 else None
