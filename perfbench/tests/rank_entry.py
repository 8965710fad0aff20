"""A cell of more than one chip at a toy size on the CPU, a rank per process
over gloo: what ``perfbench/run.py`` does, with ``toy.resolved``.

    python3 -m perfbench.tests.rank_entry --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root. Rank 0 starts the others with the same command
(``perfbench/ranks.py``). The environment plants what a test needs, in
every rank or in ``PERFBENCH_TOY_RANK`` alone:

- ``PERFBENCH_TOY_FAULT``: a fault of ``perfbench/faults.py``, by name;
- ``PERFBENCH_TOY_SLOW_S``: seconds of sleep after each of its steps;
- ``PERFBENCH_TOY_EXIT_AT``: the window step at which it exits with code 9.
"""

import os
import sys
import time

T0 = time.monotonic()

from perfbench import faults, harness  # noqa: E402
from perfbench.families import transformer_fsdp  # noqa: E402
from perfbench.tests import toy  # noqa: E402

Job = transformer_fsdp.Job


def _plant(rank: int) -> None:
    chosen = os.environ.get("PERFBENCH_TOY_RANK")
    if chosen is not None and int(chosen) != rank:
        return
    fault = os.environ.get("PERFBENCH_TOY_FAULT")
    if fault:
        faults.plant(fault)
    slow = float(os.environ.get("PERFBENCH_TOY_SLOW_S", "0"))
    exit_at = os.environ.get("PERFBENCH_TOY_EXIT_AT")
    if slow or exit_at:
        step = Job.step
        count = [0]

        def paced(self):
            loss = step(self)
            count[0] += 1
            if exit_at is not None and count[0] == harness.CHECKED_STEPS + int(exit_at):
                os._exit(9)
            time.sleep(slow)
            return loss
        Job.step = paced


def main(argv):
    args = harness.parse(argv)
    _plant(0 if args.rank is None else args.rank)
    resolved = toy.resolved(args.workload)
    command = [sys.executable, "-m", "perfbench.tests.rank_entry", *argv]
    return harness.run(resolved, args, T0, "cpu", command)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
