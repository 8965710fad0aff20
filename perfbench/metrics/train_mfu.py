"""train_mfu: model flops of the window's steps over the window's seconds
(whole cycles, less the benchmark's checks), as a share of the card's
float32-accurate peak (165 TFLOP/s, ``roofline.PEAK_F32_FLOPS``)."""

from perfbench import roofline


def read(ctx):
    flops = ctx.job.flops_per_step()
    steps, seconds = ctx.window.get("steps"), ctx.window.get("window_s")
    if flops is None or not steps or not seconds:
        return None
    return 100.0 * flops * steps / seconds / roofline.PEAK_F32_FLOPS
