#!/usr/bin/env python3
"""How far the ResNet dp-2 gates of ``chip_smoke.py`` sit from the faults
they are there to catch, on one card.

    python3 tools/resnet_dp_faults.py

Runs ``chip_smoke.phase_resnet`` (the CNN at ResNet-18's widths, batch
128, f32 with TF32 off) with the sound dp-2 step and then the same step
twice more with a fault injected into its ranks: the gradient all-reduce
left out (``no_grad_sum``), and batch statistics of each rank's rows
alone (``rank_stats``). Prints the phase's JSON line (the sound readings
under ``dp_*``, each fault's under ``faults``), the card's name and power
limit, and exits non-zero if a gate passes a fault or fails the sound
step.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("resnet_dp_faults.py needs a CUDA device; none is available.", file=sys.stderr)
        return 2
    chip_smoke.phase_resnet(faults=tuple(chip_smoke.RESNET_DP_FAULTS))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
