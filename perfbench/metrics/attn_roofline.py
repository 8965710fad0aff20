"""attn_roofline: the flash kernels' (K1 forward, K2 dq, K3 dk/dv) least
time at the step's shape, over their device time, in the profiled cycles."""

from perfbench import roofline


def read(ctx):
    shape = ctx.job.attention_shape()
    if shape is None:
        return None
    bound = device = 0.0
    for e in ctx.device_in_window(("kernel",)):
        for kernel, least in roofline.FLASH_KERNELS.items():
            if kernel in str(e.get("name")):
                bound += least(*shape)
                device += e["dur"] / 1e6
                break
    return 100.0 * bound / device if device > 0 else None
