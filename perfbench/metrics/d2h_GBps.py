"""d2h_GBps: bytes of the device-to-host copies in the profiled cycles over
their device seconds."""

from perfbench.metrics import copy_rate


def read(ctx):
    return copy_rate(ctx, "DtoH")
