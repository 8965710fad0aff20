#!/usr/bin/env python
"""The hottier phase of ``chip_smoke.py`` alone, on a CUDA card.

``chip_smoke.py`` runs its hottier phase beside the faults phase, so its
times there are taken beside that load; this runs the same phase with
nothing beside it: the device phase, the fingerprint kernel's build
(so that no take pays for it), then ``phase_hottier`` in this process,
with the same gates. It prints the phase's JSON record and its summary
line, and exits 0 only if every gate held. About 3 minutes on an H100.

    python3 tools/hottier_phase.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    if not cs.torch.cuda.is_available():
        print("hottier_phase.py needs a CUDA device; none is available.", file=sys.stderr)
        return 2
    smi, _ = cs.phase_device()
    cs.build.build_all(["fingerprint"])
    cs.build.load_library("fingerprint")
    cs.phase_hottier(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
