"""h2d_GBps: bytes of the host-to-device copies in the profiled cycles over
their device seconds."""

from perfbench.metrics import copy_rate


def read(ctx):
    return copy_rate(ctx, "HtoD")
