"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use, by ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface under
``build/torch_kernels/`` at the repository root (``build/`` is not
committed). The library's file name carries a hash of its source, of
every shared header ``csrc/*.cuh`` and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded. A failed build
raises with the compiler's output; there is no fallback. Nothing here
runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Compiler output (ptxas register/shared-memory report) of the builds
# this process ran, by kernel name.
build_logs: Dict[str, str] = {}


_TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc") or _TOOLKIT_NVCC
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc was not found (PATH or /usr/local/cuda/bin); the CUDA "
            "kernels of torchsnapshot_tpu_torch build only where the CUDA "
            "toolkit is installed."
        )
    return found


def _library_path(name: str) -> Path:
    sources = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        sources.update(header.name.encode() + header.read_bytes())
    sources.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{sources.hexdigest()[:16]}.so"


def build_all(names: List[str]) -> None:
    """Build every named kernel that is not built yet, all ``nvcc``
    processes started together; raise with the output of any that fail."""
    with _lock:
        started = []
        for name in names:
            out = _library_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            started.append((name, out, tmp, proc))
        errors = []
        for name, out, tmp, proc in started:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed to build {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return lib
