#!/usr/bin/env python
"""The read_plane phase of ``chip_smoke.py`` alone, on a CUDA card.

Runs the device phase, builds the two kernel libraries the phase
launches (the flash forward, K1, and the fingerprint kernels, K4 and K5)
so that no replica pays for the build, then ``phase_read_plane`` in this
process with the same gates: four replica processes restoring the
GPT-2-XL-width state through one snapserve server process, a
``verify_device`` restore through it, a chunk take restored as row
halves by a gloo world of 2 (chunk pushdown), a fleet of two server
processes with one SIGKILLed mid-restore, and faultline's
``kill_server``. It prints the phase's JSON record and its summary
lines, and exits 0 only if every gate held. About 3 minutes on an H100.

    python3 tools/read_plane_phase.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    if not cs.torch.cuda.is_available():
        print("read_plane_phase.py needs a CUDA device; none is available.", file=sys.stderr)
        return 2
    smi, _ = cs.phase_device()
    cs.build.build_all(["flash_fwd", "fingerprint"])
    cs.build.load_library("flash_fwd")
    cs.build.load_library("fingerprint")
    cs.phase_read_plane(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
