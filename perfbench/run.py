"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``torchsnapshot_tpu_torch``)
on a machine with the CUDA devices the cell asks for. Kernel and compiler
caches stay inside the checkout, at fixed paths under ``build/``.
"""

import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "cache" / sub)
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
