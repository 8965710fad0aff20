"""library_idle_pct: share of the profiled cycles in which the card is idle
while the training thread is inside the program's ``Snapshot.async_take``,
``CheckpointManager.wait`` or ``CheckpointManager.restore`` span, the
program's spans put on the profiler's clock (``perfbench/program_trace.py``).
``device_idle`` less this is the idle while the loop was not held by the
library."""

from perfbench import program_trace


def read(ctx):
    program = program_trace.for_context(ctx)
    if program is None:
        return None
    found = program_trace.library_idle_seconds(ctx, program)
    if found is None or found[1] <= 0:
        return None
    idle, window = found
    return 100.0 * idle / window
