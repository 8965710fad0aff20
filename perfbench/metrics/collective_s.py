"""collective_s: device seconds of the NCCL kernels (FSDP's all-gathers and
reduce-scatters, the loss's all-reduce) per training step, in the profiled
cycles on rank 0's card. A collective's kernel runs from its launch until
every rank has joined it, so a rank's wait for the others counts here."""


def read(ctx):
    profiled = set(ctx.window.get("profiled_cycles", []))
    steps = sum(1 for s in ctx.named("step") if s.get("cycle") in profiled)
    seconds = sum(e["dur"] / 1e6 for e in ctx.device_in_window(("kernel",))
                  if "nccl" in str(e.get("name")).lower())
    return seconds / steps if steps and seconds > 0 else None
