"""device_idle: share of the profiled cycles with no kernel, copy or set on
the card."""

from perfbench.tracer import busy_and_window


def read(ctx):
    found = busy_and_window(ctx)
    if found is None or found[1] <= 0:
        return None
    busy, window = found
    return 100.0 * (1.0 - busy / window)
