#!/usr/bin/env python3
"""Times configurations of the flash forward kernel against each other on
one NVIDIA GPU.

    python3 tools/flash_fwd_variants.py [--rounds 3] [--baseline DIR]

``csrc/flash_fwd.cu`` is one kernel template, ``Cfg<T, kD, kMT, kN>``:
each warp owns kMT m16 tiles of query rows and a key tile has kN keys.
The entry point ``flash_fwd`` runs one configuration per input type and
head_dim; this script builds the others, each into its own library (the
source included as it is, one ``nvcc`` each, all started together), and
runs every configuration of a case on the same inputs in turns (each
round in the opposite order of the one before), with the entry point
among them. ``--baseline DIR`` adds the ``flash_fwd`` entry point built
from another checkout's ``csrc`` directory (an earlier commit, unpacked),
so two versions of the kernel are compared within one process on one
card. Every result is held against ``flash_attention_reference`` at
``chip_smoke.py``'s tolerance and checked bitwise deterministic across
two launches.

Prints one JSON line per (case, configuration) with its mean ms over the
rounds, the ptxas report of each build, and the card's name and power
limit. Needs CUDA and nvcc; exits non-zero without them.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from torchsnapshot_tpu_torch.ops import attention, build  # noqa: E402

_CTYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
           torch.float16: "__half"}

# (case, B, Hq, Hkv, S, D, dtype, causal, [(kMT, kN), ...]).
CASES = [
    ("main_path", 4, 25, 25, 1024, 64, torch.float32, True,
     [(2, 32), (1, 32), (1, 64), (2, 64)]),
    ("d128_f32", 1, 16, 16, 2048, 128, torch.float32, True, [(1, 64), (1, 32)]),
    ("single_bf16", 1, 25, 25, 1024, 64, torch.bfloat16, True, [(1, 64), (1, 32)]),
    ("gqa_f16", 2, 32, 8, 2048, 128, torch.float16, True, [(1, 64), (1, 32)]),
]

_SOURCE = """#include "{src}"
extern "C" int flash_fwd_variant(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int b, int hq, int hkv, int s_len, int d,
                                 float scale, int causal, void* stream) {{
  return (int)launch<Cfg<{ctype}, {kd}, {mt}, {kn}>>(
      q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal,
      static_cast<cudaStream_t>(stream));
}}
"""


def _name(dtype, kd, cfg):
    mt, kn = cfg
    return f"{str(dtype).replace('torch.', '')}_d{kd}_mt{mt}_n{kn}"


def build_variants(workdir, baseline):
    """{name: (library path, ptxas report)} for every configuration, and
    "baseline" for the entry point of ``baseline``/flash_fwd.cu if given."""
    os.makedirs(workdir, exist_ok=True)
    src = os.path.join(build.CSRC_DIR, "flash_fwd.cu")
    started = {}

    def start(name, cu):
        lib = os.path.join(workdir, f"lib{name}.so")
        proc = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (lib, proc)

    if baseline:
        start("baseline", os.path.join(os.path.abspath(baseline), "flash_fwd.cu"))
    for _, _, _, _, _, d, dtype, _, cfgs in CASES:
        kd = 64 if d <= 64 else 128
        for cfg in cfgs:
            name = _name(dtype, kd, cfg)
            if name in started:
                continue
            cu = os.path.join(workdir, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(_SOURCE.format(src=src, ctype=_CTYPES[dtype], kd=kd, mt=cfg[0],
                                       kn=cfg[1]))
            start(name, cu)
    built = {}
    for name, (lib, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}:\n{log}")
        report = [line.strip() for line in log.splitlines()
                  if "registers" in line or "spill" in line]
        built[name] = (lib, report)
    return built


def _variant_call(lib_path, q, k, v, causal):
    """A configuration's launch, or with lib "baseline" the entry point
    ``flash_fwd`` (its C signature is that of attention._kernel_fn), on
    contiguous inputs whose rows are whole 16-byte pieces."""
    lib = ctypes.CDLL(lib_path)
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    if hasattr(lib, "flash_fwd_variant"):
        fn = lib.flash_fwd_variant
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        args = (*pointers, b, hq, k.shape[1], s, d, 1.0 / d**0.5, int(causal))
    else:
        fn = lib.flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        args = (*pointers, b, hq, k.shape[1], s, d, attention._DTYPE_CODES[q.dtype],
                int(causal), 1.0 / d**0.5)
    fn.restype = ctypes.c_int

    def call():
        return fn(*args, torch.cuda.current_stream().cuda_stream)

    return call, (out, lse)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--baseline", help="a csrc directory whose flash_fwd.cu to time too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_variants.py needs a CUDA device; none is available.", file=sys.stderr)
        return 2
    smi, _ = chip_smoke.phase_device()
    begin = time.perf_counter()
    built = build_variants(os.path.join(build.BUILD_DIR, "variants"), args.baseline)
    build.build_all(["flash_fwd"])
    chip_smoke.emit({"phase": "variants_build", "seconds": time.perf_counter() - begin,
                     "ptxas": {name: report for name, (_, report) in built.items()}})
    gen = torch.Generator(device="cuda").manual_seed(99)
    for case, b, hq, hkv, s, d, dtype, causal, cfgs in CASES:
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        ref, ref_lse = attention.flash_attention_reference(q, k, v, causal)
        kd = 64 if d <= 64 else 128
        calls = {"entry_point": attention._forward_kernel_call(q, k, v, causal)}
        if args.baseline:
            calls["baseline"] = _variant_call(built["baseline"][0], q, k, v, causal)
        for cfg in cfgs:
            name = _name(dtype, kd, cfg)
            calls[name] = _variant_call(built[name][0], q, k, v, causal)
        atol, rtol = chip_smoke.OUT_TOL[dtype]
        records = {}
        for name, (call, (out, lse)) in calls.items():
            chip_smoke._checked(call())
            torch.cuda.synchronize()
            first = (out.clone(), lse.clone())
            chip_smoke._checked(call())
            torch.cuda.synchronize()
            out_err = (out.float() - ref.float()).abs()
            lse_err = (lse - ref_lse).abs()
            records[name] = {
                "phase": "variant", "case": case, "config": name,
                "max_abs_err": float(out_err.max()),
                "lse_max_abs_err": float(lse_err.max()),
                "within_tolerance": chip_smoke.within(out_err, ref.float(), atol, rtol)
                and chip_smoke.within(lse_err, ref_lse, *chip_smoke.LSE_TOL),
                "determinism": chip_smoke._bitwise_equal(out, first[0])
                and chip_smoke._bitwise_equal(lse, first[1]),
                "ms_rounds": [],
            }
        order = list(calls)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                call = calls[name][0]
                records[name]["ms_rounds"].append(
                    chip_smoke.cuda_ms(lambda: chip_smoke._checked(call()), args.iters))
        library_ms = chip_smoke.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, **({"enable_gqa": True} if hkv != hq else {})),
            args.iters)
        for record in records.values():
            record["ms"] = sum(record["ms_rounds"]) / len(record["ms_rounds"])
            record["library_ms"] = library_ms
            chip_smoke.emit(record)
        del q, k, v, ref, ref_lse, calls
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
