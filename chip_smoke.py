#!/usr/bin/env python3
"""Drives torchsnapshot_tpu_torch on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each printing JSON lines to stdout:

1. device — the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. build — nvcc builds every kernel from ``torchsnapshot_tpu_torch/csrc``.
3. kernel — the flash forward kernel against its plain PyTorch version
   at the main path's shape and the shapes around it, with the tolerance
   stated, its time, the plain version's, the time of
   ``torch.nn.functional.scaled_dot_product_attention`` on the same
   inputs (a yardstick only: the port never calls it) and the least time
   the card could take for the same work. The shapes include the ring
   path's chunk ([4,25,256,64] f32, causal and full) and the Ulysses
   path's full-sequence attention ([4,10,1024,64] f32).
4. kernel_bwd — the two flash backward kernels (dq; dk and dv) against
   the plain backward at the train path's shape and the shapes around
   it (f32, bf16, f16; causal or not; GQA; ragged S; head_dim 128 and
   80), with the tolerance stated, a check that two launches give
   bitwise-equal results, each kernel's time and bound, the plain
   version's time and, as the pair's yardstick, the backward of
   ``scaled_dot_product_attention`` on the same inputs. The ring and
   Ulysses shapes are among them, and one ring-chunk case goes through
   ``flash_attention_backward`` with a non-zero lse cotangent, against the
   plain backward with the same delta' = rowsum(dO·O) − dlse.
5. transfer — pinned device→host and host→device copy rates over 1 GiB,
   and the rate at which fresh host memory is pinned.
5b. kernel_fingerprint — the xs128 kernels K4 (one tensor, or a box of
   it read as runs in place) and K5 (per chunk) against their plain
   versions, run on the card, and the host fingerprint, bit for bit, at
   177 cases (nine dtypes from bool to f64, empty and odd lengths, 1-byte
   views at odd offsets, boxes along either dim, chunk sizes that do not
   divide), each launched twice; then their times at the 40.96 MB w1,
   the 321.6 MB embed and the 387 leaves of the state, beside the byte
   bound, the integer bound (the busier pipe's SASS instructions of the
   main loop, from ``cuobjdump``), the plain version's time and
   ``x.view(torch.int32).sum()`` over the same bytes as an HBM yardstick
   (no PyTorch call computes xs128).
6. main path — the flagship transformer at GPT-2 XL's widths (1.56 B
   float32 parameters, 6.23 GB): a forward pass on 4 requests of 1024
   tokens through the flash kernel; ``Snapshot.take`` of the model, a
   progress counter and the RNG streams to the local filesystem (twice,
   each with the pinned blocks the host allocator created for it),
   beside that filesystem's write+fsync and read rates; a restore into a
   second model of other values, with its GB/s against the read rate,
   its consume profile (``read_wait``, ``verify``, ``reassemble``,
   ``pool_wait``, ``staging_release``, ``other``, and the H2D pipeline's
   ``h2d_overlap`` seconds, bytes and GB/s against the pinned H2D rate),
   the bytes streamed and placed, the device budget and its high water,
   and the peak card memory over the restore's start; every leaf
   byte-equal on the card; a second forward with bit-identical logits;
   one weight read back with ``read_object``; a second restore (the
   staging pool's hits, misses and waits; no pinned block created); a
   third at an 8 MiB read threshold, where every attention and MLP weight
   streams (leaves byte-equal, logits bit-identical). Then the flash
   forward is held against the einsum forward on a short input.
6a. dedup — on the main path's model (GPT-2 XL widths, 387 leaves,
   6.23 GB): a full take with fingerprints, an incremental take of the
   unchanged state (0 array bytes written, 0 bytes device→host, one K4
   launch a leaf), an in-place change to two whole layers and the first
   1,000 rows of ``embed``, an incremental take writing exactly those 17
   leaves, a ``verify_device=True`` restore into a fresh model with
   bit-identical logits; three ``chunks=True`` takes (the state; the
   unchanged state, 0 chunk objects; after the same change again, exactly
   the touched chunks of the 4 MiB grid), a restore of the last with
   bit-identical logits, and deletes of the middle (every chunk shared:
   none freed) and the first (its exclusive chunks freed). Each take
   prints its seconds, payload bytes and objects written, chunk objects
   stored, bytes copied to the host and the K4/K5 milliseconds within it.
6b. torn leaf — a copy of a small chunked snapshot with one corrupt
   chunk, then an injected failure of an H2D pipeline transfer, then a
   20 MiB single-object leaf (two staging-slot transfers) whose second
   transfer fails, each restored into a CUDA template of other values:
   all raise and leave the template bit-equal to its old values; the
   retries are bit-exact.
7. train path — the same model trained with ``sgd_train_step`` on 4 × 1024
   tokens, every step through the three flash kernels (48 launches each
   per step), checkpointed as a training job does through
   ``CheckpointManager(max_to_keep=1)``: a sync save, a step, an
   ``async_save(stage="device")`` whose drain overlaps the next in-place
   step, retention, and the restore of the latest step into a second
   model, byte-equal to the state the async save captured (its GB/s,
   consume profile and pool), and a second device-staged drain of the
   state; the pinned blocks each save and drain created. Then one
   step's gradients through the flash kernels are held against plain
   autograd of the einsum attention on a short input.
8. multi rank — the same model at full widths and depth across ranks
   that share the card as processes of one gloo process group (NCCL
   refuses two ranks on one GPU), each building the state on the card
   from the same seed: at world 2, the Megatron tensor-parallel layout
   on a ``{"tp": 2}`` DeviceMesh, ``CheckpointManager(max_to_keep=1)``
   saves step 1 with ``replicated=["**"]``, an in-place change to one
   leaf, an ``async_save(stage="device")`` of step 2 and the retention
   that prunes step 1; at world 4, an FSDP-style layout (dim 0 of every
   leaf over ``{"tp": 4}``) restores step 2, every local shard
   byte-equal to its box of the changed state, reading only its boxes'
   bytes (each rank's consume profile and pool); at world 1 (this process), the restore of step 2 into a plain
   model on the card, byte-equal, and a forward on 4 × 1024 tokens
   through the flash kernel with logits bit-identical to those of a
   model built from the seed with the same change.
9. ring — the flagship at GPT-2 XL's widths and full depth, f32, 4 ×
   1024 tokens, trained one step by two processes sharing the card over
   gloo on a ``{"sp": 2}`` DeviceMesh: zigzag ring attention with flash
   chunks, so K1–K3 run as chunk kernels (5 chunk attentions a layer a
   rank: 240 launches of each kernel a step). The reference is one
   process's flash step on the same weights and tokens, run first: the
   ranks' losses are equal and within rtol 1e-4 of it, and the gradients
   of ``embed``, ``layers/0/attn/wq``, ``layers/47/mlp/w2`` and
   ``final_ln`` within 1e-3 of each one's largest reference entry. Each
   rank reports its step time, the bytes it sent through the ring and
   the other collectives, how many were staged through host memory (the
   helpers stage CUDA tensors on a gloo group), its peak card memory,
   and the step's transport alone: the gradient all-reduce, and the
   hops (or all-to-alls) on tensors of the same sizes.
10. ulysses — the same at gpt2-large's widths and full depth (n_embd
    1280, 20 heads, 36 layers, n_inner 5120: GPT-2 XL's 25 heads do not
    divide by sp 2), with Ulysses all-to-all attention through the flash
    kernels (36 launches of each a step).
11. kernels — one JSON line summarising every kernel of the paths (K4
    and K5 with their launches on the dedup path).

The last line is ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero, as does a host without CUDA.

Float32 matrix products run at full float32 precision (TF32 off), and
deterministic algorithms are on in the main path (with
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts), so two forward
passes over the same bytes give bit-identical logits. The train path
claims no bit-identity and turns them off.
"""

import ctypes
import dataclasses
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from torchsnapshot_tpu_torch import (  # noqa: E402
    CheckpointManager,
    RNGState,
    Snapshot,
    StateDict,
)
from torchsnapshot_tpu_torch import io_preparer, staging_pool  # noqa: E402
from torchsnapshot_tpu_torch.io_types import io_payload  # noqa: E402
from torchsnapshot_tpu_torch import snapshot as snapshot_mod  # noqa: E402
from torchsnapshot_tpu_torch.manifest import ArrayEntry  # noqa: E402
from torchsnapshot_tpu_torch.models import transformer as tf  # noqa: E402
from torchsnapshot_tpu_torch.ops import attention, build, transfer  # noqa: E402
from torchsnapshot_tpu_torch.parallel import collectives  # noqa: E402
from torchsnapshot_tpu_torch.parallel.mesh import make_mesh, shard_pytree  # noqa: E402
from torchsnapshot_tpu_torch.resharding import shard_box  # noqa: E402
from torchsnapshot_tpu_torch.serialization import dtype_itemsize  # noqa: E402
from torchsnapshot_tpu_torch.storage_plugins import fs as fs_plugin  # noqa: E402
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess  # noqa: E402
from torchsnapshot_tpu_torch.utils.train_state import PytreeStateful  # noqa: E402

KERNELS = ["flash_fwd", "flash_bwd", "fingerprint"]

# NVIDIA H100 SXM data sheet, dense tensor-core rates: 989 TFLOP/s for
# bf16 and f16; 495 TFLOP/s for TF32. An f32-accurate product is at least
# three TF32 products (3xTF32: hi·hi + hi·lo + lo·hi, each operand split
# into two TF32 terms, as the backward kernels and PyTorch's
# memory-efficient SDPA backward compute float), so the least time for f32
# work is at 495/3 = 165 TFLOP/s; the 67 TFLOP/s f32 rate outside the
# tensor cores is slower. HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12, torch.float16: 989e12}
PEAK_BYTES_PER_S = 3.35e12

# |kernel - plain| <= atol + rtol * |plain|. f32: the kernel's products
# are 3xTF32 (hi·hi + hi·lo + lo·hi of tf32 splits, f32-accurate; the CPU
# emulation in tests/test_torch_attention.py lands at 1-2 % of this
# tolerance), summed in another order: held as tests/test_flash_attention.py
# holds the Pallas kernel to its einsum spec. bf16/f16: both round one f32
# result to the output type, and f32 results differing in the last bits
# may round to neighbouring values, one ulp (2^-8 bf16, 2^-11 f16) apart.
# The lse is f32 in every case.
OUT_TOL = {
    torch.float32: (2e-5, 1e-5),
    torch.bfloat16: (1e-2, 8e-3),
    torch.float16: (2e-3, 1e-3),
}
LSE_TOL = (2e-5, 1e-5)

GPT2_XL = tf.TransformerConfig(
    vocab_size=50257,
    d_model=1600,
    n_heads=25,
    n_layers=48,
    d_ff=6400,
    max_seq_len=1024,
    dtype=torch.float32,
    flash_attention=True,
)
BATCH, SEQ = 4, 1024

# (name, B, Hq, Hkv, S, D, dtype, causal); the first is the main path's.
FLASH_SHAPES = [
    ("main_path", BATCH, 25, 25, SEQ, 64, torch.float32, True),
    ("single_f32", 1, 25, 25, 1024, 64, torch.float32, True),
    ("single_bf16", 1, 25, 25, 1024, 64, torch.bfloat16, True),
    ("single_f16", 1, 25, 25, 1024, 64, torch.float16, True),
    ("noncausal_bf16", 1, 25, 25, 1024, 64, torch.bfloat16, False),
    ("gqa_bf16", 2, 32, 8, 2048, 128, torch.bfloat16, True),
    ("ragged_f32", 1, 25, 25, 1000, 64, torch.float32, True),
    ("d128_f32", 1, 16, 16, 2048, 128, torch.float32, True),
    ("odd_d_bf16", 1, 8, 8, 512, 80, torch.bfloat16, False),
    ("gqa_f16", 2, 32, 8, 2048, 128, torch.float16, True),
    # The ring path's chunk at sp 2 under zigzag (4 x 1024 tokens, a
    # sub-chunk of 256), causal on the diagonal and full on the past;
    # the Ulysses path's full-sequence attention on 10 of gpt2-large's 20
    # heads.
    ("ring_chunk_causal", BATCH, 25, 25, 256, 64, torch.float32, True),
    ("ring_chunk_full", BATCH, 25, 25, 256, 64, torch.float32, False),
    ("ulysses_heads", BATCH, 10, 10, SEQ, 64, torch.float32, True),
]


# (name, B, Hq, Hkv, S, D, dtype, causal); the first is the train path's.
BWD_SHAPES = [
    ("train_path", BATCH, 25, 25, SEQ, 64, torch.float32, True),
    ("single_bf16", 1, 25, 25, 1024, 64, torch.bfloat16, True),
    ("noncausal_bf16", 1, 25, 25, 1024, 64, torch.bfloat16, False),
    ("gqa_bf16", 2, 32, 8, 2048, 128, torch.bfloat16, True),
    ("ragged_f32", 1, 25, 25, 1000, 64, torch.float32, True),
    ("single_f16", 1, 25, 25, 1024, 64, torch.float16, True),
    ("d128_f32", 1, 16, 16, 2048, 128, torch.float32, True),
    ("odd_d_bf16", 1, 8, 8, 512, 80, torch.bfloat16, False),
    ("ring_chunk_causal", BATCH, 25, 25, 256, 64, torch.float32, True),
    ("ring_chunk_full", BATCH, 25, 25, 256, 64, torch.float32, False),
    ("ring_chunk_dlse", BATCH, 25, 25, 256, 64, torch.float32, False),
    ("ulysses_heads", BATCH, 10, 10, SEQ, 64, torch.float32, True),
]
# Cases whose lse cotangent is not zero, as a ring chunk's is (the merge
# differentiates through the lse): they go through flash_attention_backward
# with a d_lse, whose delta' = rowsum(dO·O) − dlse the plain backward gets.
DLSE_CASES = {"ring_chunk_dlse"}

# |kernel - plain| <= atol + rtol * |plain| for dq, dk and dv. The plain
# version computes in f32 from the same inputs (bf16/f16 inputs are exact
# in f32); the kernels' products are f32-accurate (3xTF32 for f32, exact
# 16-bit products and hi + lo splits of p and ds otherwise) and sum in
# another order, so every dtype is held to one f32-level tolerance.
BWD_TOL = (1e-4, 1e-4)


def emit(record):
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs,
    from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(b, hq, hkv, s, d, dtype, causal):
    """(least ms, "bytes" or "operations") for one flash forward: Q·Kᵀ and
    P·V over the (query, key) pairs the mask keeps, 2 flops per
    multiply-add each, at the card's peak for the input type; q, k, v read
    once and out, lse written once at HBM bandwidth."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * hq * d * pairs
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize + b * hq * s * 4
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bwd_bound(b, hq, hkv, s, d, dtype, causal, products, out_heads):
    """(least ms, "bytes" or "operations") for one backward kernel:
    ``products`` matrix products of 2·D flops per (query, key) pair the
    mask keeps, at the card's peak for the input type; q, dO, k, v read
    once in their type, lse and delta in f32, and f32 [B,h,S,D] outputs of
    ``out_heads`` heads in all written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = products * 2 * d * b * hq * pairs
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = ((2 * b * hq + 2 * b * hkv) * s * d * itemsize
              + 2 * b * hq * s * 4
              + out_heads * b * s * d * 4)
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def within(err, ref, atol, rtol):
    return bool((err <= atol + rtol * ref.abs()).all())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit(info)
    return smi, info


def phase_build():
    begin = time.perf_counter()
    build.build_all(KERNELS)
    seconds = time.perf_counter() - begin
    for name in KERNELS:
        build.load_library(name)
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    # ptxas reports static shared memory only; the forward's is dynamic.
    smem = build.load_library("flash_fwd").flash_fwd_smem_bytes
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    fwd_smem = {
        f"{str(dtype).replace('torch.', '')}_d{d}": smem(code, d)
        for dtype, code in attention._DTYPE_CODES.items() for d in (64, 128)
    }
    emit({"phase": "build", "kernels": KERNELS, "seconds": seconds,
          "flash_fwd_smem_bytes": fwd_smem})


def phase_kernel():
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for name, b, hq, hkv, s, d, dtype, causal in FLASH_SHAPES:
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        out, lse = attention.flash_attention_with_lse(q, k, v, causal)
        torch.cuda.synchronize()
        ref, ref_lse = attention.flash_attention_reference(q, k, v, causal)
        out_err = (out.float() - ref.float()).abs()
        lse_err = (lse - ref_lse).abs()
        atol, rtol = OUT_TOL[dtype]
        ok = within(out_err, ref.float(), atol, rtol) and within(
            lse_err, ref_lse, *LSE_TOL
        )
        again, again_lse = attention.flash_attention_with_lse(q, k, v, causal)
        torch.cuda.synchronize()
        determinism = _bitwise_equal(out, again) and _bitwise_equal(lse, again_lse)
        del again, again_lse
        # The C entry point alone, bound as the wrapper binds it.
        call, _ = attention._forward_kernel_call(q, k, v, causal)
        kernel_ms = cuda_ms(lambda: _checked(call()), 20)
        plain_ms = cuda_ms(lambda: attention.flash_attention_reference(q, k, v, causal), 5, 1)
        gqa = {"enable_gqa": True} if hkv != hq else {}
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, **gqa), 20
        )
        bound_ms, bound_by = flash_bound(b, hq, hkv, s, d, dtype, causal)
        record = {
            "phase": "kernel",
            "kernel": "flash_fwd",
            "case": name,
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d},
            "dtype": str(dtype).replace("torch.", ""),
            "causal": causal,
            "max_abs_err": float(out_err.max()),
            "lse_max_abs_err": float(lse_err.max()),
            "tolerance": {"out": [atol, rtol], "lse": list(LSE_TOL)},
            "within_tolerance": ok,
            "determinism": determinism,
            "kernel_ms": kernel_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        emit(record)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version: {record}")
        if not determinism:
            raise AssertionError(f"flash_fwd gave two results on one input: {record}")
        results[name] = record
        del q, k, v, out, lse, ref, ref_lse, call
        torch.cuda.empty_cache()
    return results


def _bitwise_equal(a, b):
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def _checked(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError_t {err}")


def phase_kernel_bwd():
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for name, b, hq, hkv, s, d, dtype, causal in BWD_SHAPES:
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        d_out = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
        out, lse = attention.flash_attention_with_lse(q, k, v, causal)
        # The train path's lse cotangent is zero: delta = rowsum(dO·O).
        delta = (d_out.float() * out.float()).sum(dim=-1, keepdim=True)
        if name in DLSE_CASES:
            d_lse = torch.randn(lse.shape, generator=gen, device="cuda")
            delta = delta - d_lse
            got = attention.flash_attention_backward(q, k, v, out, lse, d_out, d_lse, causal)
        else:
            got = attention._launch_flash_backward(q, k, v, d_out, lse, delta, causal)
        torch.cuda.synchronize()
        ref = attention.flash_attention_backward_reference(
            q, k, v, out, lse, d_out, delta, causal
        )
        record = {
            "phase": "kernel_bwd",
            "case": name,
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d},
            "dtype": str(dtype).replace("torch.", ""),
            "causal": causal,
            "d_lse": name in DLSE_CASES,
            "tolerance": list(BWD_TOL),
        }
        ok = True
        for grad, g, r in zip(("dq", "dk", "dv"), got, ref):
            err = (g - r).abs()
            record[f"{grad}_max_abs_err"] = float(err.max())
            record[f"{grad}_max_abs"] = float(r.abs().max())
            ok = ok and within(err, r, *BWD_TOL)
        record["max_abs_err"] = max(record[f"{g}_max_abs_err"] for g in ("dq", "dk", "dv"))
        again = attention._launch_flash_backward(q, k, v, d_out, lse, delta, causal)
        torch.cuda.synchronize()
        record["determinism"] = all(_bitwise_equal(a, b_) for a, b_ in zip(got, again))
        record["within_tolerance"] = ok
        del got, ref, again
        # The C entry points alone, bound as the wrapper binds them.
        dq_call, dkv_call, _ = attention._backward_kernel_calls(
            q, k, v, d_out, lse, delta, causal)
        record["dq_kernel_ms"] = cuda_ms(lambda: _checked(dq_call()), 10)
        record["dkv_kernel_ms"] = cuda_ms(lambda: _checked(dkv_call()), 10)
        record["plain_ms"] = cuda_ms(
            lambda: attention.flash_attention_backward_reference(
                q, k, v, out, lse, d_out, delta, causal), 3, 1)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        gqa = {"enable_gqa": True} if hkv != hq else {}
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, **gqa)
        record["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(sdpa, (qg, kg, vg), d_out, retain_graph=True), 10)
        for kernel, products, out_heads in (("dq", 3, hq), ("dkv", 4, 2 * hkv)):
            bound, bound_by = bwd_bound(b, hq, hkv, s, d, dtype, causal, products, out_heads)
            record[f"{kernel}_bound_ms"] = bound
            record[f"{kernel}_bound_by"] = bound_by
        emit(record)
        if not ok:
            raise AssertionError(f"flash_bwd disagrees with its plain version: {record}")
        if not record["determinism"]:
            raise AssertionError(f"flash_bwd gave two results on one input: {record}")
        results[name] = record
        del q, k, v, d_out, out, lse, delta, qg, kg, vg, sdpa, dq_call, dkv_call
        torch.cuda.empty_cache()
    return results


# xs128 (K4, K5). The payload bytes are read once; each u32 word costs
# about forty integer instructions for the four lanes (the SASS loop is
# counted at run time). They issue on two pipes of 64 lanes an SM each
# (132 SMs at the 1.98 GHz boost clock of the data sheet, whose 67
# TFLOP/s f32 is 128 lanes × 2): IMAD, IMUL and VIADD on the FMA pipe,
# the shifts, LOP3s, adds and the rest on the integer ALU pipe. The
# integer bound is the busier pipe's instructions at 64 lanes × 132 SMs
# × 1.98e9 a second.
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP_SOURCE_OPS_PER_WORD = 40
FP_FMA_PIPE = ("IMAD", "IMUL", "VIADD")
FP_CHUNK_BYTES = 4 << 20  # the chunk store's default grid
FP_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.float16, torch.bfloat16,
             torch.float32, torch.int32, torch.int64, torch.float64]


def _sass_ops_per_word():
    """Instructions in the main loop of the 16-byte-load K4/K5 kernel,
    from ``cuobjdump -sass`` of the built library, per u32 word (the loop
    handles four words). None where cuobjdump is missing or no loop is
    found."""
    import re

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(build._library_path("fingerprint"))
    try:
        sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    best = None
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        if "xs128_kernel" not in name or "ILi0E" not in name:
            continue
        addr_of, labels, instrs = {}, {}, []
        pending = []
        for line in body.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            instrs.append((addr, m.group(2).strip()))
        for addr, text in instrs:
            if "BRA" not in text:
                continue
            t = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
            if not t:
                continue
            target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
            if target is None or target >= addr:
                continue
            loop = [x for a, x in instrs if target <= a <= addr and not x.startswith("NOP")]
            if any("LDG" in x and ".128" in x for x in loop):
                ops = {}
                for x in loop:
                    op = x.split()[0] if not x.startswith("@") else x.split()[1]
                    ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
                fma = sum(n for op, n in ops.items() if op in FP_FMA_PIPE)
                alu = sum(n for op, n in ops.items() if op not in FP_FMA_PIPE and op != "BRA")
                cand = {"kernel": name.strip(), "loop_instructions": len(loop),
                        "ops_per_word": len(loop) / 4, "fma_pipe_per_word": fma / 4,
                        "alu_pipe_per_word": alu / 4, "opcodes": ops}
                if best is None or cand["loop_instructions"] > best["loop_instructions"]:
                    best = cand
    return best


def _fp_bound(nbytes, ops_per_word):
    """(bound ms, "bytes" or "operations", byte ms, integer ms)."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = math.ceil(nbytes / 4) * ops_per_word / PEAK_INT32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms else "bytes", bytes_ms, ops_ms)


def _lanes_err(a, b):
    """Largest |a - b| over the u32 lanes of two int32 result tensors."""
    ua = a.cpu().numpy().view("uint32").astype("int64")
    ub = b.cpu().numpy().view("uint32").astype("int64")
    return int(abs(ua - ub).max()) if ua.size else 0


def phase_kernel_fingerprint():
    """K4 and K5 against their plain versions (run on the card) and the
    host twins, bit for bit, at every dtype of the tests and their edges
    (empty, odd lengths, 1-byte views at odd offsets, one-dim boxes, a
    chunk size that does not divide), each launched twice; then their
    times at the dedup path's shapes beside both bounds, the plain
    version's time and the int32-sum HBM reference, the wrappers' results
    there held bit for bit against the plain versions too."""
    from torchsnapshot_tpu_torch import fingerprint as fp
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    gen = torch.Generator(device="cuda").manual_seed(29)
    cases, worst = 0, 0
    failures = []

    def check(name, x, box=None, chunk_bytes=None):
        nonlocal cases, worst
        host = (x if box is None else x[tuple(slice(a, b) for a, b in box)]).contiguous().cpu()
        if chunk_bytes is None:
            outs = [fops.fingerprint_box(x, box) for _ in range(2)]
            plain = fops.fingerprint_box_reference(x, box)
            want = [fp.fingerprint_host(host)]
            got = [fp.resolve_fingerprints([o])[0] for o in outs]
        else:
            outs = [fops.fingerprint_chunked(x, chunk_bytes) for _ in range(2)]
            plain = fops.fingerprint_chunked_reference(x, chunk_bytes)
            want = fp.fingerprint_host_chunked(host, chunk_bytes)
            got = [fp.resolve_chunk_fingerprints([o])[0] for o in outs]
        torch.cuda.synchronize()
        err = max(_lanes_err(o, plain) for o in outs)
        worst = max(worst, err)
        cases += 1
        if err or got[0] != got[-1] or (got[0] != want[0] if chunk_bytes is None else got[0] != want):
            failures.append(name)

    for dtype in FP_DTYPES:
        for n in (0, 1, 3, 13, 4097, (1 << 20) + 3):
            if dtype == torch.bool:
                x = torch.rand(n, generator=gen, device="cuda") > 0.5
            elif dtype.is_floating_point:
                x = torch.randn(n, generator=gen, device="cuda").to(dtype)
            else:
                x = torch.randint(-100, 100, (n,), generator=gen, device="cuda").to(dtype)
            check(f"k4_{dtype}_{n}", x)
            for cb in (12, 4096):
                check(f"k5_{dtype}_{n}_{cb}", x, chunk_bytes=cb)
    base = torch.randint(-100, 100, (100003,), generator=gen, device="cuda").to(torch.int8)
    for offset in (1, 2, 3):
        check(f"k4_offset_{offset}", base[offset:])
        check(f"k5_offset_{offset}", base[offset:], chunk_bytes=4096)
    for dtype in (torch.float32, torch.float16, torch.int8):
        m = torch.randn(64, 129, generator=gen, device="cuda").to(dtype)
        for box in ([(3, 40), (0, 129)], [(0, 64), (5, 77)], [(0, 64), (1, 2)]):
            check(f"k4_box_{dtype}_{box}", m, box=box)

    sass = _sass_ops_per_word()
    # The busier pipe's instructions a word; without SASS, the source's
    # forty split evenly over the two pipes.
    ops_per_word = (max(sass["fma_pipe_per_word"], sass["alu_pipe_per_word"]) if sass
                    else FP_SOURCE_OPS_PER_WORD / 2)
    shapes = {"w1": [(GPT2_XL.d_model, GPT2_XL.d_ff)], "embed": [(GPT2_XL.vocab_size, GPT2_XL.d_model)],
              "state": _gpt2_xl_shapes(GPT2_XL)}
    timings = {}
    for name, leaf_shapes in shapes.items():
        leaves = [torch.randn(s, generator=gen, device="cuda") for s in leaf_shapes]
        nbytes = sum(t.numel() * 4 for t in leaves)
        k4 = [fops.box_kernel_call(t)[0] for t in leaves]
        k5 = [fops.chunked_kernel_call(t, FP_CHUNK_BYTES)[0] for t in leaves]
        row = {"leaves": len(leaves), "bytes": nbytes,
               "k4_ms": cuda_ms(lambda: [_checked(c()) for c in k4], 10),
               "k5_ms": cuda_ms(lambda: [_checked(c()) for c in k5], 10),
               "int32_sum_ms": cuda_ms(lambda: [t.view(torch.int32).sum() for t in leaves], 10)}
        # The wrappers at the path's shapes, held bit for bit against the
        # plain versions on the same leaves (whose time is taken on the way).
        plain = {}
        iters, warmup = (1, 0) if name == "state" else (3, 1)
        row["k4_plain_ms"] = cuda_ms(
            lambda: plain.update(k4=[fops.fingerprint_box_reference(t) for t in leaves]), iters, warmup)
        row["k5_plain_ms"] = cuda_ms(
            lambda: plain.update(k5=[fops.fingerprint_chunked_reference(t, FP_CHUNK_BYTES) for t in leaves]),
            iters, warmup)
        got4 = [fops.fingerprint_box(t) for t in leaves]
        got5 = [fops.fingerprint_chunked(t, FP_CHUNK_BYTES) for t in leaves]
        torch.cuda.synchronize()
        row["k4_max_abs_err"] = max(_lanes_err(g, w) for g, w in zip(got4, plain["k4"]))
        row["k5_max_abs_err"] = max(_lanes_err(g, w) for g, w in zip(got5, plain["k5"]))
        cases += 2 * len(leaves)
        worst = max(worst, row["k4_max_abs_err"], row["k5_max_abs_err"])
        if row["k4_max_abs_err"] or row["k5_max_abs_err"]:
            failures.append(f"path_shapes_{name}")
        row["bound_ms"], row["bound_by"], row["bytes_bound_ms"], row["integer_bound_ms"] = _fp_bound(
            nbytes, ops_per_word)
        row["k4_gbps"] = nbytes / 1e6 / row["k4_ms"]
        timings[name] = row
        del leaves, k4, k5, plain, got4, got5
        torch.cuda.empty_cache()
    record = {"phase": "kernel_fingerprint", "cases": cases, "max_abs_err": worst,
              "failures": failures, "sass": sass, "pipe_ops_per_word": ops_per_word,
              "ops_per_word_source": "sass" if sass else "source count",
              "peak_int32_ops_per_s": PEAK_INT32_OPS_PER_S, "timings": timings}
    emit(record)
    if failures or worst:
        raise AssertionError(f"the fingerprint kernels disagree: {failures[:10]}, max err {worst}")
    return record


class _TakeMeter:
    """What one take moved: payload bytes written and objects stored
    (chunk objects apart), bytes copied device→host, and the device time
    of the fingerprint kernels it launched (CUDA events around each)."""

    def __init__(self):
        from torchsnapshot_tpu_torch import chunkstore
        from torchsnapshot_tpu_torch.ops import fingerprint as fops

        self._patches = [
            (fs_plugin.FSStoragePlugin, "write"),
            (io_preparer, "device_to_host"),
            (chunkstore, "device_to_host"),
            (fops, "_run"),
        ]
        self._orig = [getattr(o, n) for o, n in self._patches]
        self.reset()
        meter = self
        write, d2h_a, d2h_b, run = self._orig

        async def counting_write(plugin, io_req):
            n = len(io_payload(io_req))
            if "objects/" in io_req.path:
                meter.chunk_objects += 1
                meter.chunk_bytes += n
            elif not io_req.path.startswith((".snapshot_metadata", ".completed", "refs/", "intents/")):
                meter.payload_bytes += n
                meter.payload_objects += 1
            return await write(plugin, io_req)

        def counting_d2h(orig):
            def d2h(src, ready=None):
                meter.d2h_bytes += src.numel() * src.element_size()
                return orig(src, ready)
            return d2h

        def timed_run(call, out, name):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(call, out, name)
            end.record()
            meter.events.append((name, start, end))

        self._new = [counting_write, counting_d2h(d2h_a), counting_d2h(d2h_b), timed_run]

    def reset(self):
        self.payload_bytes = self.payload_objects = self.chunk_objects = 0
        self.chunk_bytes = self.d2h_bytes = 0
        self.events = []

    def __enter__(self):
        for (o, n), new in zip(self._patches, self._new):
            setattr(o, n, new)
        return self

    def __exit__(self, *exc):
        for (o, n), old in zip(self._patches, self._orig):
            setattr(o, n, old)

    def take(self, record, key, fn):
        self.reset()
        torch.cuda.synchronize()
        begin = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - begin
        kernel_ms = {"xs128_box": 0.0, "xs128_chunked": 0.0}
        for name, start, end in self.events:
            kernel_ms[name] += start.elapsed_time(end)
        record[key] = {
            "seconds": seconds, "payload_bytes_written": self.payload_bytes,
            "payload_objects_written": self.payload_objects, "chunk_objects_stored": self.chunk_objects,
            "chunk_bytes_stored": self.chunk_bytes, "d2h_bytes": self.d2h_bytes,
            "k4_ms": kernel_ms["xs128_box"], "k5_ms": kernel_ms["xs128_chunked"],
            "k4_launches": sum(n == "xs128_box" for n, _, _ in self.events),
            "k5_launches": sum(n == "xs128_chunked" for n, _, _ in self.events),
        }
        return result


def _touched_chunks(leaf, rows):
    """How many chunks of the chunk store's grid over ``leaf`` its first
    ``rows`` rows (None: all of it) overlap; 0 for a leaf below the
    store's size floor (written whole, unchunked)."""
    from torchsnapshot_tpu_torch import chunkstore

    itemsize = leaf.element_size()
    if leaf.numel() * itemsize < chunkstore.chunk_min_bytes():
        return 0
    elems, n = chunkstore._chunk_grid(leaf.numel(), itemsize, chunkstore.chunk_bytes())
    if rows is None:
        return n
    end = min(rows, leaf.shape[0]) * (leaf.numel() // leaf.shape[0])
    return -(-end // elems)


def _dedup_profile():
    """The last restore's consume thread-seconds by sub-step, and the
    bytes it streamed."""
    block = snapshot_mod._last_restore_report
    subs = block["substeps"]
    out = {name: subs.get(name, {}).get("seconds", 0.0)
           for name in ("read_wait", "decode", "verify", "reassemble", "pool_wait", "other", "h2d_overlap")}
    out["streamed_bytes"] = block["scheduler"].get("streamed_bytes")
    out["read_s"] = block["scheduler"].get("ops", {}).get("read", {}).get("seconds")
    return out


def phase_dedup(model, tokens):
    """Deduplication at GPT-2 XL widths, full depth, f32 (387 leaves,
    6.23 GB), on the main path's model: a full take with fingerprints; an
    incremental take of the unchanged state (0 array bytes written, 0
    bytes copied to the host, one K4 launch a leaf); an in-place change
    to two whole layers and the first 1,000 rows of ``embed``; an
    incremental take that writes exactly the changed leaves; a restore of
    it into a fresh model with ``verify_device=True`` and bit-identical
    logits. Then three ``chunks=True`` takes into one run (the state, the
    unchanged state: 0 chunk objects, the state after the same change
    again: exactly the touched chunks of the 4 MiB grid), a restore of the
    last with bit-identical logits, and deletes of the middle (every
    chunk shared: nothing freed) and the first (its exclusive chunks
    freed, the last's kept)."""
    from torchsnapshot_tpu_torch import chunkstore
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    cfg = GPT2_XL
    params = model.params()
    leaves = list(tf.param_leaves(params))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dedup-")
    free = shutil.disk_usage(workdir).free
    if free < 2.5 * state_bytes:
        shutil.rmtree(workdir)
        raise RuntimeError(f"{workdir} has {free} bytes free; the dedup phase needs {2.5 * state_bytes:.0f}")
    record = {"phase": "dedup", "model": "GPT-2 XL widths, f32", "leaves": len(leaves),
              "state_bytes": state_bytes}
    changed_layers = (10, 20)
    embed_rows = 1000

    def change():
        with torch.no_grad():
            for i in changed_layers:
                for t in tf.param_leaves(params["layers"][i]):
                    t.add_(1e-3)
            params["embed"][:embed_rows].add_(1e-3)

    changed = [t for i in changed_layers for t in tf.param_leaves(params["layers"][i])] + [params["embed"]]
    predicted = sum(t.numel() * t.element_size() for t in changed)

    def logits_of(m):
        with torch.no_grad():
            out = m(tokens)
        torch.cuda.synchronize()
        return out

    def fresh_restore(path, **kwargs):
        fresh = tf.Transformer.init(cfg, seed=1)
        Snapshot(path).restore({"model": tf.TransformerState(fresh)}, **kwargs)
        out = logits_of(fresh)
        del fresh
        return out

    app = {"model": tf.TransformerState(model)}
    inc = os.path.join(workdir, "inc")
    ck = os.path.join(workdir, "ck")
    try:
        _reset_launch_counts()
        with _TakeMeter() as meter:
            full = meter.take(record, "full_take", lambda: Snapshot.take(
                os.path.join(inc, "full"), app, fingerprint=True))
            same = meter.take(record, "incremental_unchanged", lambda: Snapshot.take(
                os.path.join(inc, "same"), app, base=full))
            change()
            logits_changed = logits_of(model)
            meter.take(record, "incremental_changed", lambda: Snapshot.take(
                os.path.join(inc, "changed"), app, base=same))
            record["incremental_changed"]["predicted_bytes"] = predicted
            record["incremental_changed"]["changed_leaves"] = len(changed)
            begin = time.perf_counter()
            k4_before = fops.fingerprint_box_launches
            restored = fresh_restore(os.path.join(inc, "changed"), verify_device=True)
            record["verify_device_restore_s"] = time.perf_counter() - begin
            record["verify_device"] = {**snapshot_mod._last_verify_stats,
                                       "k4_launches": fops.fingerprint_box_launches - k4_before}
            record["verify_device_restore_profile"] = _dedup_profile()
            record["verify_device_logits_bit_identical"] = bool(torch.equal(restored, logits_changed))
            del restored

            # Each chunk take launches K5 once a leaf above the store's size
            # floor; the first also probes K5 once a dtype.
            chunkstore._FP_AGREEMENT.clear()
            eligible = [t for t in leaves if _touched_chunks(t, None)]
            probes = len({t.dtype for t in eligible})
            for step in (1, 2):
                meter.take(record, f"chunk_take_{step}", lambda: Snapshot.take(
                    os.path.join(ck, f"step-{step}"), app, chunks=True))
            change()
            logits_twice = logits_of(model)
            touched = sum(_touched_chunks(t, None) for t in changed[:-1])
            touched += _touched_chunks(params["embed"], embed_rows)
            meter.take(record, "chunk_take_3", lambda: Snapshot.take(
                os.path.join(ck, "step-3"), app, chunks=True))
            record["chunk_take_3"]["predicted_chunks"] = touched
            begin = time.perf_counter()
            restored = fresh_restore(os.path.join(ck, "step-3"))
            record["chunk_restore_s"] = time.perf_counter() - begin
            record["chunk_restore_profile"] = _dedup_profile()
            record["chunk_logits_bit_identical"] = bool(torch.equal(restored, logits_twice))
            del restored
        record["launches"] = {"xs128_box": fops.fingerprint_box_launches,
                              "xs128_chunked": fops.fingerprint_chunked_launches}

        def store_keys():
            return {os.path.basename(p) for p in glob.glob(os.path.join(ck, ".chunkstore", "objects", "*", "*"))}

        manifests = {s: Snapshot(os.path.join(ck, f"step-{s}")).get_manifest() for s in (1, 2, 3)}
        keys = {s: chunkstore.chunk_keys_of(m) for s, m in manifests.items()}
        record["chunked_leaves"] = {f"step-{s}": sum(bool(getattr(e, "chunks", None)) for e in m.values())
                                    for s, m in manifests.items()}
        record["eligible_leaves"], record["k5_probes"] = len(eligible), probes
        before = store_keys()
        Snapshot(os.path.join(ck, "step-2")).delete()
        after_middle = store_keys()
        Snapshot(os.path.join(ck, "step-1")).delete()
        after_first = store_keys()
        record["gc"] = {
            "store_chunks": len(before), "after_deleting_middle": len(after_middle),
            "after_deleting_first": len(after_first), "exclusive_to_first": len(keys[1] - keys[3]),
            "last_snapshot_chunks": len(keys[3]),
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit(record)
    n = len(leaves)
    unchanged, changed_take = record["incremental_unchanged"], record["incremental_changed"]
    gates = {
        "full take fingerprints every leaf": record["full_take"]["k4_launches"] == n,
        "unchanged take writes no array byte": unchanged["payload_bytes_written"] == 0,
        "unchanged take copies no byte to the host": unchanged["d2h_bytes"] == 0,
        "unchanged take launches K4 once a leaf": unchanged["k4_launches"] == n,
        "changed take writes exactly the changed leaves": changed_take["payload_bytes_written"] == predicted
        and changed_take["payload_objects_written"] == len(changed),
        "verify_device restore is bit-identical": record["verify_device_logits_bit_identical"],
        "verify_device verifies every leaf with K4": record["verify_device"]
        == {"verified": n, "skipped": 0, "k4_launches": n},
        "every chunk take chunks every eligible leaf": all(
            c == len(eligible) for c in record["chunked_leaves"].values()),
        "chunk takes launch K5 once an eligible leaf": [
            record[f"chunk_take_{s}"]["k5_launches"] for s in (1, 2, 3)]
        == [len(eligible) + probes, len(eligible), len(eligible)],
        "first chunk take stores the state": record["chunk_take_1"]["chunk_bytes_stored"] > 0.99 * state_bytes,
        "unchanged chunk take stores no chunk": record["chunk_take_2"]["chunk_objects_stored"] == 0,
        "changed chunk take stores the touched chunks": record["chunk_take_3"]["chunk_objects_stored"] == touched,
        "chunked restore is bit-identical": record["chunk_logits_bit_identical"],
        "deleting the middle frees nothing shared": after_middle == before,
        "deleting the first frees its exclusive chunks": after_first == keys[3]
        and len(before) - len(after_first) == len(keys[1] - keys[3]),
        "K4 and K5 ran on the path": all(record["launches"].values()),
    }
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"dedup phase: {failed}")
    return record


def phase_transfer():
    nbytes = 1 << 30
    # Page-locking fresh host memory is part of a first take's cost: each
    # staged tensor gets a new pinned buffer, which PyTorch's host
    # allocator caches for later takes of the same process.
    begin = time.perf_counter()
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    alloc_s = time.perf_counter() - begin
    del pinned
    record = {
        "phase": "transfer",
        "bytes": nbytes,
        "pinned_alloc_gbps": nbytes / 1e9 / alloc_s,
        "d2h_pinned_gbps": transfer.probe_d2h_gbps(nbytes),
        "h2d_pinned_gbps": transfer.probe_h2d_gbps(nbytes),
    }
    emit(record)
    torch.cuda.empty_cache()
    return record


def _filesystem(path):
    """(mount point, type) of the filesystem holding ``path``."""
    best = ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            mount, fstype = fields[1], fields[2]
            if path.startswith(mount) and len(mount) >= len(best[0]):
                best = (mount, fstype)
    return best


def storage_ceilings(workdir, nbytes=1 << 30, files=16):
    """The snapshot directory's write+fsync and read rates in GB/s, with
    the fs plugin's write concurrency and the scheduler's read fan-out:
    the ceilings a take and a restore are measured against."""
    from concurrent.futures import ThreadPoolExecutor

    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    payload = os.urandom(nbytes // files)
    names = [os.path.join(workdir, f"probe{i}") for i in range(files)]

    def write(name):
        with open(name, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())

    def read(name):
        with open(name, "rb") as f:
            return len(f.read())

    with ThreadPoolExecutor(FSStoragePlugin.max_write_concurrency) as pool:
        begin = time.perf_counter()
        list(pool.map(write, names))
        write_s = time.perf_counter() - begin
    with ThreadPoolExecutor(16) as pool:
        begin = time.perf_counter()
        total = sum(pool.map(read, names))
        read_s = time.perf_counter() - begin
    for name in names:
        os.remove(name)
    return {
        "fs_write_fsync_gbps": total / 1e9 / write_s,
        "fs_read_gbps": total / 1e9 / read_s,
    }


def phase_main_path(h2d_pinned_gbps):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    cfg = GPT2_XL
    model_a = tf.Transformer.init(cfg, seed=0)
    model_b = tf.Transformer.init(cfg, seed=1)
    leaves_a = list(tf.param_leaves(model_a.params()))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves_a)
    n_params = sum(t.numel() for t in leaves_a)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    free = shutil.disk_usage(workdir).free
    if free < 3 * state_bytes:
        shutil.rmtree(workdir)
        raise RuntimeError(
            f"{workdir} has {free} bytes free; two takes need room for "
            f"three times the state, {3 * state_bytes} bytes. Point TMPDIR "
            f"at a larger disk."
        )
    path = os.path.join(workdir, "snap")
    record = {
        "phase": "main_path",
        "model": "GPT-2 XL widths, f32, flash attention",
        "params": n_params,
        "leaves": len(leaves_a),
        "state_bytes": state_bytes,
        "tokens": [BATCH, SEQ],
        "filesystem": list(_filesystem(os.path.realpath(workdir))),
    }
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        # The main path's launch counts start here.
        _reset_launch_counts()
        with torch.no_grad():
            begin = time.perf_counter()
            logits_a = model_a(tokens)
            torch.cuda.synchronize()
            record["forward_s"] = time.perf_counter() - begin
        record["launches_first_forward"] = attention.flash_forward_launches
        if attention.flash_forward_launches != cfg.n_layers:
            raise AssertionError(
                f"{attention.flash_forward_launches} flash launches in one "
                f"forward; expected {cfg.n_layers}"
            )
        if tuple(logits_a.shape) != (BATCH, SEQ, cfg.vocab_size):
            raise AssertionError(f"logits shape {tuple(logits_a.shape)}")
        if not bool(torch.isfinite(logits_a).all()):
            raise AssertionError("non-finite logits")

        app_a = {
            "model": tf.TransformerState(model_a),
            "progress": StateDict(step=1000),
            "rng": RNGState(),
        }
        pinned = _pinned_blocks()
        begin = time.perf_counter()
        Snapshot.take(path, app_a)
        take_s = time.perf_counter() - begin
        record["pinned_blocks_created_take1"] = _pinned_delta(pinned)
        stored = sum(
            math.prod(e.shape) * dtype_itemsize(e.dtype)
            for e in Snapshot(path).get_manifest().values()
            if isinstance(e, ArrayEntry)
        )
        record.update(take_s=take_s, take_gbps=stored / 1e9 / take_s, stored_bytes=stored)
        # A second take of the same state: the pinned blocks the host
        # allocator created for it (none if the first take's were cached).
        pinned = _pinned_blocks()
        begin = time.perf_counter()
        Snapshot.take(os.path.join(workdir, "snap2"), app_a)
        take2_s = time.perf_counter() - begin
        record["pinned_blocks_created_take2"] = _pinned_delta(pinned)
        shutil.rmtree(os.path.join(workdir, "snap2"))
        record.update(second_take_s=take2_s, second_take_gbps=stored / 1e9 / take2_s)
        record.update(storage_ceilings(workdir))

        # Every leaf but the norm scales (ones in both models) differs
        # before the restore.
        differs = sum(
            not torch.equal(a, b) for a, b in zip(leaves_a, tf.param_leaves(model_b.params()))
        )
        if differs != len(leaves_a) - (2 * cfg.n_layers + 1):
            raise AssertionError("the second model does not start from other values")
        progress = StateDict(step=0)
        app_b = {"model": tf.TransformerState(model_b), "progress": progress, "rng": RNGState()}
        largest = max(t.numel() * t.element_size() for t in leaves_a)
        torch.cuda.synchronize()
        record["peak_gb_before_restore"] = _peak_gb()
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pinned = _pinned_blocks()
        begin = time.perf_counter()
        Snapshot(path).restore(app_b)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - begin
        record["pinned_blocks_created_restore"] = _pinned_delta(pinned)
        record["restore_pool_stats"] = _pool_stats()
        record.update(restore_s=restore_s, restore_gbps=stored / 1e9 / restore_s,
                      restore_over_fs_read=stored / 1e9 / restore_s / record["fs_read_gbps"],
                      restore_peak_extra_gb=(torch.cuda.max_memory_allocated() - allocated) / 1e9)
        _restore_profile(record, "restore_profile", state_bytes, largest, h2d_pinned_gbps)
        # At the default threshold only the tied embedding (above 64 MiB)
        # is read as streamed sub-ranges.
        streamed = record["restore_profile"]["streamed_bytes"]
        if streamed != sum(t.numel() * t.element_size() for t in leaves_a
                           if t.numel() * t.element_size() > 64 << 20):
            raise AssertionError(f"{streamed} bytes streamed at the default threshold")

        leaves_b = list(tf.param_leaves(model_b.params()))
        equal = sum(
            b.is_cuda and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(leaves_a, leaves_b)
        )
        record["leaves_byte_equal_on_cuda"] = equal
        if equal != len(leaves_a) or progress["step"] != 1000:
            raise AssertionError(f"{equal}/{len(leaves_a)} leaves restored byte-equal")

        with torch.no_grad():
            logits_b = model_b(tokens)
        torch.cuda.synchronize()
        record["logits_bit_identical"] = bool(torch.equal(logits_a, logits_b))
        if not record["logits_bit_identical"]:
            raise AssertionError("logits after restore differ")

        last = cfg.n_layers - 1
        w2 = model_a.params()["layers"][last]["mlp"]["w2"]
        got = Snapshot(path).read_object(
            f"model/layers/{last}/mlp/w2", template=torch.empty_like(w2)
        )
        record["read_object_equal"] = bool(got.is_cuda and torch.equal(got, w2))
        if not record["read_object_equal"]:
            raise AssertionError("read_object returned other bytes")

        def zero_b():
            with torch.no_grad():
                for t in tf.param_leaves(model_b.params()):
                    t.zero_()
            torch.cuda.synchronize()

        def leaves_equal():
            return sum(
                b.is_cuda and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in zip(leaves_a, tf.param_leaves(model_b.params()))
            )

        # A second restore in this process: the pool's pinned buffers are
        # reused, and the host allocator creates no pinned block. (A pool
        # miss, when more pieces of one size are in flight than in the
        # first restore, is served from the host allocator's cache.)
        zero_b()
        pool_before, pinned = _pool_stats(), _pinned_blocks()
        begin = time.perf_counter()
        Snapshot(path).restore(app_b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - begin
        pool_after = _pool_stats()
        record["second_restore"] = {
            "seconds": seconds,
            "gbps": stored / 1e9 / seconds,
            "pool": {k: pool_after[k] - pool_before.get(k, 0)
                     for k in ("hits", "misses", "waits", "pinned_allocs")},
            "pool_stats": pool_after,
            "pinned_blocks_created": _pinned_delta(pinned),
            "leaves_byte_equal": leaves_equal(),
        }
        _restore_profile(record["second_restore"], "profile", state_bytes, largest, h2d_pinned_gbps)
        second = record["second_restore"]
        if (second["pool"]["hits"] <= 0 or second["pinned_blocks_created"] not in (0, None)
                or second["leaves_byte_equal"] != len(leaves_a)):
            raise AssertionError(f"second restore: {second}")

        # Once more with an 8 MiB read threshold: every attention and MLP
        # weight (10.24 and 40.96 MB) streams too.
        zero_b()
        os.environ["TPUSNAPSHOT_PARALLEL_READ_THRESHOLD"] = str(8 << 20)
        try:
            begin = time.perf_counter()
            Snapshot(path).restore(app_b)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - begin
        finally:
            del os.environ["TPUSNAPSHOT_PARALLEL_READ_THRESHOLD"]
        small = {"seconds": seconds, "gbps": stored / 1e9 / seconds,
                 "leaves_byte_equal": leaves_equal()}
        _restore_profile(small, "profile", state_bytes, largest, h2d_pinned_gbps)
        want = sum(t.numel() * t.element_size() for t in leaves_a
                   if t.numel() * t.element_size() > 8 << 20)
        with torch.no_grad():
            logits_c = model_b(tokens)
        torch.cuda.synchronize()
        small["logits_bit_identical"] = bool(torch.equal(logits_a, logits_c))
        record["restore_8mib_threshold"] = small
        if (small["profile"]["streamed_bytes"] != want or small["leaves_byte_equal"] != len(leaves_a)
                or not small["logits_bit_identical"]):
            raise AssertionError(f"8 MiB-threshold restore: {small}, {want} bytes should stream")
        del logits_c
        record["flash_launches"] = attention.flash_forward_launches
        # The main path's launch counts end here.
        record["peak_gb"] = max(record["peak_gb_before_restore"], _peak_gb())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del logits_b, got

    # The output against the repo's reference path: the flash forward vs
    # the einsum forward (plain PyTorch attention) on a short input.
    einsum_cfg = dataclasses.replace(cfg, flash_attention=False)
    short = tokens[:1, :128]
    with torch.no_grad():
        flash_logits = tf.forward(model_a.params(), short, cfg)
        einsum_logits = tf.forward(model_a.params(), short, einsum_cfg)
    err = float((flash_logits - einsum_logits).abs().max())
    scale = float(einsum_logits.abs().max())
    record.update(reference_max_abs_err=err, reference_max_abs=scale)
    # The attention outputs agree to ~1e-6 relative; the residual layers
    # carry that into the logits, bounded here relative to their size.
    if not err <= 1e-3 * max(1.0, scale):
        raise AssertionError(f"flash and einsum forwards differ by {err}")
    emit(record)
    del model_b, logits_a
    torch.cuda.empty_cache()
    return record, model_a, tokens


def phase_torn_leaf():
    """A restore that fails leaves a CUDA template as it was: a copy of a
    small chunked snapshot (four 256 KiB chunk objects, each read as four
    streamed 64 KiB sub-ranges) with one corrupt chunk, then an injected
    failure of the third H2D pipeline transfer, then a single-object leaf
    of 20 MiB (two staging slots: two transfers) whose second transfer is
    made to fail; each must raise with the template bit-equal to its old
    values, and the clean retries restore bit-exactly."""
    from concurrent.futures import Future

    record = {"phase": "torn_leaf"}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_torn-")
    chunk_max = io_preparer.MAX_CHUNK_SIZE_BYTES
    io_preparer.MAX_CHUNK_SIZE_BYTES = 256 << 10
    os.environ["TPUSNAPSHOT_PARALLEL_READ_THRESHOLD"] = str(64 << 10)
    submit = transfer.H2DPipeline.submit
    try:
        gen = torch.Generator(device="cuda").manual_seed(13)
        w = torch.randn(1 << 18, generator=gen, device="cuda")
        old = torch.randn(1 << 18, generator=gen, device="cuda")
        path = os.path.join(workdir, "snap")
        Snapshot.take(path, {"m": StateDict(w=w)})
        target = StateDict(w=old.clone())
        victim = os.path.join(path, "chunked", "0", "m", "w__chunk_3")
        with open(victim, "rb") as f:
            good = f.read()
        record["chunk_objects"] = len(os.listdir(os.path.dirname(victim)))
        with open(victim, "wb") as f:
            f.write(good[:1000] + bytes([good[1000] ^ 0x55]) + good[1001:])
        try:
            Snapshot(path).restore({"m": target})
            record["corrupt_chunk_error"] = None
        except RuntimeError as e:
            record["corrupt_chunk_error"] = str(e)
        record["corrupt_chunk_template_untouched"] = bool(torch.equal(target["w"], old))
        with open(victim, "wb") as f:
            f.write(good)

        calls = [0]

        def failing(self, *args, **kwargs):
            calls[0] += 1
            if calls[0] == 3:
                fut = Future()
                fut.set_exception(RuntimeError("injected transfer failure"))
                return fut
            return submit(self, *args, **kwargs)

        transfer.H2DPipeline.submit = failing
        try:
            Snapshot(path).restore({"m": target})
            record["transfer_failure_error"] = None
        except RuntimeError as e:
            record["transfer_failure_error"] = str(e)
        transfer.H2DPipeline.submit = submit
        record["transfer_failure_template_untouched"] = bool(torch.equal(target["w"], old))
        Snapshot(path).restore({"m": target})
        torch.cuda.synchronize()
        record["retry_bit_exact"] = bool(torch.equal(target["w"].view(torch.int32), w.view(torch.int32)))

        # A whole-object read whose bytes go to the card as several
        # transfers: the first lands before the second fails.
        io_preparer.MAX_CHUNK_SIZE_BYTES = chunk_max
        del os.environ["TPUSNAPSHOT_PARALLEL_READ_THRESHOLD"]
        big = torch.randn(5 << 20, generator=gen, device="cuda")
        big_old = torch.randn(5 << 20, generator=gen, device="cuda")
        big_path = os.path.join(workdir, "big")
        Snapshot.take(big_path, {"m": StateDict(w=big)})
        big_target = StateDict(w=big_old.clone())
        calls[0] = 0

        def failing_second(self, *args, **kwargs):
            calls[0] += 1
            if calls[0] == 2:
                fut = Future()
                fut.set_exception(RuntimeError("injected transfer failure"))
                return fut
            return submit(self, *args, **kwargs)

        transfer.H2DPipeline.submit = failing_second
        try:
            Snapshot(big_path).restore({"m": big_target})
            record["multi_slot_failure_error"] = None
        except RuntimeError as e:
            record["multi_slot_failure_error"] = str(e)
        transfer.H2DPipeline.submit = submit
        torch.cuda.synchronize()
        record["multi_slot_transfers_before_failure"] = calls[0]
        record["multi_slot_template_untouched"] = bool(
            torch.equal(big_target["w"].view(torch.int32), big_old.view(torch.int32))
        )
        Snapshot(big_path).restore({"m": big_target})
        torch.cuda.synchronize()
        record["multi_slot_retry_bit_exact"] = bool(
            torch.equal(big_target["w"].view(torch.int32), big.view(torch.int32))
        )
    finally:
        transfer.H2DPipeline.submit = submit
        io_preparer.MAX_CHUNK_SIZE_BYTES = chunk_max
        os.environ.pop("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", None)
        shutil.rmtree(workdir, ignore_errors=True)
    emit(record)
    if not (
        record["chunk_objects"] == 4
        and "Checksum mismatch" in (record["corrupt_chunk_error"] or "")
        and record["corrupt_chunk_template_untouched"]
        and "injected transfer failure" in (record["transfer_failure_error"] or "")
        and record["transfer_failure_template_untouched"]
        and record["retry_bit_exact"]
        and "injected transfer failure" in (record["multi_slot_failure_error"] or "")
        and record["multi_slot_transfers_before_failure"] == 2
        and record["multi_slot_template_untouched"]
        and record["multi_slot_retry_bit_exact"]
    ):
        raise AssertionError(f"torn-leaf check failed: {record}")
    return record


def _launch_counts():
    return (attention.flash_forward_launches, attention.flash_bwd_dq_launches,
            attention.flash_bwd_dkv_launches)


def _reset_launch_counts():
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    attention.flash_forward_launches = 0
    attention.flash_bwd_dq_launches = 0
    attention.flash_bwd_dkv_launches = 0
    fops.fingerprint_box_launches = 0
    fops.fingerprint_chunked_launches = 0


def _peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9


# The pinned (host) allocator's count of blocks it created through CUDA:
# "num_host_alloc" in torch.cuda.host_memory_stats().
def _pinned_blocks():
    stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    for key in ("num_host_alloc", "allocations.allocated"):
        if key in stats:
            return int(stats[key])
    return None


def _pinned_delta(before):
    after = _pinned_blocks()
    return None if before is None or after is None else after - before


def _pool_stats():
    pool = staging_pool.get_staging_pool()
    return pool.stats() if pool is not None else {}


def _restore_profile(record, prefix, placed_bytes, largest_leaf, h2d_probe_gbps=None):
    """The last restore's consume profile and read-pipeline numbers, into
    ``record`` under ``prefix``; fails unless every placed byte rode the
    H2D pipeline and the device cost stayed within the budget plus one
    force-admitted region (the largest leaf)."""
    block = snapshot_mod._last_restore_report
    subs = block["substeps"]
    sched = block["scheduler"]
    out = {
        name: {"seconds": subs.get(name, {}).get("seconds", 0.0),
               "bytes": subs.get(name, {}).get("bytes", 0)}
        for name in ("read_wait", "verify", "reassemble", "pool_wait",
                     "staging_release", "other", "h2d_overlap", "overlap_other")
    }
    out["consume_s"] = block.get("consume_s")
    out["h2d_overlap_gbps"] = block.get("h2d_overlap_gbps")
    if h2d_probe_gbps and out["h2d_overlap_gbps"]:
        out["h2d_overlap_over_pinned_h2d"] = out["h2d_overlap_gbps"] / h2d_probe_gbps
    for key in ("region_bytes", "streamed_bytes", "private_bytes", "device_budget_bytes",
                "device_high_water_bytes", "stall_s", "seconds"):
        out[key] = sched.get(key)
    out["read_s"] = sched.get("ops", {}).get("read", {}).get("seconds")
    record[prefix] = out
    if out["h2d_overlap"]["bytes"] != sched["region_bytes"] or sched["region_bytes"] < placed_bytes:
        raise AssertionError(
            f"{prefix}: {out['h2d_overlap']['bytes']} bytes rode the H2D pipeline, "
            f"{sched['region_bytes']} were placed, {placed_bytes} expected at least")
    budget = sched.get("device_budget_bytes")
    if budget is not None and sched["device_high_water_bytes"] > budget + largest_leaf:
        raise AssertionError(f"{prefix}: device cost {sched['device_high_water_bytes']} "
                             f"past the budget {budget} plus one leaf")
    return out


def phase_train():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(False)
    cfg = GPT2_XL
    torch.cuda.reset_peak_memory_stats()
    model = tf.Transformer.init(cfg, seed=0)
    params = model.params()
    leaves = list(tf.param_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train-")
    progress = StateDict(step=0)
    app = {"model": tf.TransformerState(model), "progress": progress}
    record = {
        "phase": "train_path",
        "model": "GPT-2 XL widths, f32, flash attention, SGD lr 1e-2",
        "params": sum(t.numel() for t in leaves),
        "leaves": len(leaves),
        "tokens": [BATCH, SEQ],
        "filesystem": list(_filesystem(os.path.realpath(workdir))),
        "losses": [],
        "step_s": [],
    }

    def step():
        before = _launch_counts()
        torch.cuda.synchronize()
        begin = time.perf_counter()
        _, loss = tf.sgd_train_step(params, tokens, cfg)
        loss = float(loss)  # synchronises
        seconds = time.perf_counter() - begin
        added = [a - b for a, b in zip(_launch_counts(), before)]
        progress["step"] += 1
        record["losses"].append(loss)
        record["step_s"].append(seconds)
        print(f"train step {progress['step']}: loss {loss:.6f}, {seconds:.3f} s, "
              f"launches K1/K2/K3 {added}", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} at step {progress['step']}")
        if added != [cfg.n_layers] * 3:
            raise AssertionError(
                f"step {progress['step']} launched K1/K2/K3 {added} times; "
                f"expected {cfg.n_layers} each")
        return seconds

    try:
        torch.cuda.synchronize()
        # The train path's launch counts start here.
        _reset_launch_counts()
        for _ in range(3):
            step()
        record["peak_gb_train"] = _peak_gb()
        mgr = CheckpointManager(os.path.join(workdir, "run"), max_to_keep=1)
        pinned = _pinned_blocks()
        begin = time.perf_counter()
        mgr.save(1, app)
        record["sync_save_s"] = time.perf_counter() - begin
        record["pinned_blocks_created_sync_save"] = _pinned_delta(pinned)
        step()
        # The state the async save must capture, copied before it starts.
        step2_host = [t.detach().to("cpu", copy=True) for t in leaves]
        torch.cuda.reset_peak_memory_stats()
        pinned = _pinned_blocks()
        begin = time.perf_counter()
        pending = mgr.async_save(2, app, stage="device")
        returned = time.perf_counter()
        record["async_stall_s"] = returned - begin
        # The clones (6.23 GB) are allocated by now.
        record["allocated_gb_after_async_return"] = torch.cuda.memory_allocated() / 1e9
        # At once, an in-place step while the drain runs.
        record["step_during_drain_s"] = step()
        begin_wait = time.perf_counter()
        pending.wait()
        done = time.perf_counter()
        record["pinned_blocks_created_drain1"] = _pinned_delta(pinned)
        record["async_drain_s"] = done - returned
        record["async_wait_blocked_s"] = done - begin_wait
        record["peak_gb_async"] = _peak_gb()
        record["state_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
        record["sync_save_gbps"] = record["state_bytes"] / 1e9 / record["sync_save_s"]
        record["async_drain_gbps"] = record["state_bytes"] / 1e9 / record["async_drain_s"]
        record["launches"] = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                                      _launch_counts()))
        # The train path's launch counts end here.
        record["all_steps"] = mgr.all_steps()
        if record["all_steps"] != [2]:
            raise AssertionError(f"all_steps() is {record['all_steps']}, expected [2]")
        mutated = sum(
            not torch.equal(t.detach().cpu(), h) for t, h in zip(leaves, step2_host)
        )
        record["leaves_changed_by_step_during_drain"] = mutated

        torch.cuda.reset_peak_memory_stats()
        model_b = tf.Transformer.init(cfg, seed=1)
        progress_b = StateDict(step=0)
        begin = time.perf_counter()
        restored = mgr.restore({"model": tf.TransformerState(model_b), "progress": progress_b})
        torch.cuda.synchronize()
        record["restore_s"] = time.perf_counter() - begin
        record["restore_gbps"] = record["state_bytes"] / 1e9 / record["restore_s"]
        _restore_profile(record, "restore_profile", record["state_bytes"],
                         max(t.numel() * t.element_size() for t in leaves))
        record["restore_pool_stats"] = _pool_stats()
        record["restored_step"] = restored
        equal = sum(
            b.is_cuda and torch.equal(b.detach().view(torch.uint8),
                                      h.to(b.device).view(torch.uint8))
            for b, h in zip(tf.param_leaves(model_b.params()), step2_host)
        )
        record["leaves_byte_equal_to_step2_on_cuda"] = equal
        record["peak_gb_restore"] = _peak_gb()
        if restored != 2 or progress_b["step"] != 4:
            raise AssertionError(f"restored step {restored}, progress {progress_b['step']}")
        if equal != len(leaves) or mutated != len(leaves):
            raise AssertionError(
                f"{equal}/{len(leaves)} leaves restored byte-equal to the async "
                f"save's cut; {mutated} changed by the step during the drain")
        del model_b, step2_host
        # A second device-staged drain of the same state in this process:
        # the pinned blocks the host allocator creates for it.
        torch.cuda.empty_cache()
        pinned = _pinned_blocks()
        begin = time.perf_counter()
        Snapshot.async_take(os.path.join(workdir, "drain2"), app, stage="device").wait()
        record["second_drain_s"] = time.perf_counter() - begin
        record["pinned_blocks_created_drain2"] = _pinned_delta(pinned)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # One step's gradients through K1-K3 against plain autograd of the
    # einsum attention (the repo's reference path) on a short input.
    torch.cuda.empty_cache()
    short = tokens[:1, :128]
    einsum_cfg = dataclasses.replace(cfg, flash_attention=False)
    g_flash = torch.autograd.grad(tf.loss_fn(params, short, cfg), leaves)
    g_ref = torch.autograd.grad(tf.loss_fn(params, short, einsum_cfg), leaves)
    worst = 0.0
    for a, b in zip(g_flash, g_ref):
        scale = float(b.abs().max())
        if scale > 0:
            worst = max(worst, float((a - b).abs().max()) / scale)
        elif float(a.abs().max()) != 0:
            worst = math.inf
    record["grad_max_rel_err"] = worst
    # The attention gradients agree to ~1e-6 relative; 48 residual layers
    # carry that into every weight's gradient, held relative to the
    # leaf's largest entry.
    record["grad_rel_bound"] = 1e-3
    emit(record)
    if not worst <= 1e-3:
        raise AssertionError(f"flash and einsum gradients differ by {worst} (relative)")
    del g_flash, g_ref, model, params, leaves
    torch.cuda.empty_cache()
    return record


# The multi-rank phase's ranks: one spawned process each, in one gloo
# process group, all on cuda:0. A rank that fails or hangs fails the
# phase (run_multiprocess's shared deadline).
MR_RANK_TIMEOUT_S = 420.0


def _mr_change(tree):
    """The in-place change to one leaf between step 1 and step 2."""
    w1 = tree["layers"][0]["mlp"]["w1"]
    local = w1.to_local() if hasattr(w1, "to_local") else w1
    with torch.no_grad():
        local.add_(1.0)


def _mr_count_payload_bytes():
    """Count the payload bytes (not the dot-named metadata and markers)
    this process writes and reads through the fs plugin."""
    counts = {"written": 0, "read": 0}
    write, read = fs_plugin.FSStoragePlugin._write_sync, fs_plugin.FSStoragePlugin._read_sync

    def counting_write(self, io_req):
        write(self, io_req)
        if not io_req.path.startswith("."):
            data = io_req.data if io_req.data is not None else io_req.buf.getbuffer()
            counts["written"] += len(data)

    def counting_read(self, io_req):
        read(self, io_req)
        if not io_req.path.startswith("."):
            counts["read"] += len(io_req.data)

    fs_plugin.FSStoragePlugin._write_sync = counting_write
    fs_plugin.FSStoragePlugin._read_sync = counting_read
    return counts


def _mr_fsdp_rule(keys, leaf):
    return ("tp",)


def mr_save(rank, world, base, out_dir):
    """World 2: Megatron tp 2, sync save of step 1, in-place change,
    device-staged async save of step 2, retention."""
    counts = _mr_count_payload_bytes()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh({"tp": world}, "cuda")
    full = tf.init_params(GPT2_XL, seed=0)
    params = tf.shard_params(full, mesh)
    del full
    torch.cuda.empty_cache()
    app = {"model": PytreeStateful(params), "progress": StateDict(step=1)}
    mgr = CheckpointManager(base, max_to_keep=1)
    torch.cuda.synchronize()
    begin = time.perf_counter()
    mgr.save(1, app, replicated=["**"])
    save_s = time.perf_counter() - begin
    save_bytes = counts["written"]
    _mr_change(params)
    app["progress"]["step"] = 2
    begin = time.perf_counter()
    pending = mgr.async_save(2, app, replicated=["**"], stage="device")
    returned = time.perf_counter()
    pending.wait()
    done = time.perf_counter()
    record = {
        "rank": rank,
        "local_bytes": sum(t.to_local().numel() * t.element_size() for t in tf.param_leaves(params)),
        "save_bytes": save_bytes,
        "save_s": save_s,
        "async_stall_s": returned - begin,
        "async_drain_s": done - returned,
        "async_bytes": counts["written"] - save_bytes,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if rank == 0:
        record["all_steps"] = mgr.all_steps()
    with open(os.path.join(out_dir, f"save_{rank}.json"), "w") as f:
        json.dump(record, f)


def mr_restore(rank, world, base, out_dir):
    """World 4: restore the latest step into dim 0 of every leaf over
    ``{"tp": 4}``; every local shard byte-equal to its box of the
    changed seed state."""
    counts = _mr_count_payload_bytes()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh({"tp": world}, "cuda")
    expected = tf.init_params(GPT2_XL, seed=0)
    _mr_change(expected)
    template = shard_pytree(expected, mesh, _mr_fsdp_rule)
    for t in tf.param_leaves(template):
        t.to_local().fill_(float("nan"))
    state = PytreeStateful(template)
    progress = StateDict(step=0)
    torch.cuda.synchronize()
    begin = time.perf_counter()
    step = CheckpointManager(base).restore({"model": state, "progress": progress})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - begin
    equal = 0
    leaves = list(tf.param_leaves(state.tree))
    for got, want in zip(leaves, tf.param_leaves(expected)):
        offsets, sizes = shard_box(
            list(want.shape), list(mesh.shape), mesh.get_coordinate(), got.placements
        )
        box = tuple(slice(o, o + n) for o, n in zip(offsets, sizes))
        local = got.to_local()
        equal += bool(
            local.is_cuda and torch.equal(local.view(torch.uint8), want[box].contiguous().view(torch.uint8))
        )
    local = [t.to_local() for t in leaves]
    record = {
        "rank": rank,
        "step": step,
        "progress": progress["step"],
        "restore_s": restore_s,
        "read_bytes": counts["read"],
        "local_bytes": sum(t.numel() * t.element_size() for t in local),
        "leaves": len(leaves),
        "leaves_byte_equal": equal,
        "embed_local_shape": list(state.tree["embed"].to_local().shape),
        "pool": _pool_stats(),
    }
    _restore_profile(record, "restore_profile", record["local_bytes"],
                     max(t.numel() * t.element_size() for t in local))
    with open(os.path.join(out_dir, f"restore_{rank}.json"), "w") as f:
        json.dump(record, f)


def _mr_records(out_dir, kind, world):
    records = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"{kind}_{rank}.json")) as f:
            records.append(json.load(f))
    return records


def phase_multi_rank():
    cfg = GPT2_XL
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mr-")
    base = os.path.join(workdir, "run")
    out_dir = os.path.join(workdir, "records")
    os.makedirs(out_dir)
    record = {
        "phase": "multi_rank",
        "model": "GPT-2 XL widths, f32, flash attention",
        "filesystem": list(_filesystem(os.path.realpath(workdir))),
    }
    try:
        state_bytes = 4 * sum(
            math.prod(s) for s in _gpt2_xl_shapes(cfg)
        )
        if shutil.disk_usage(workdir).free < 3 * state_bytes:
            raise RuntimeError(
                f"{workdir} has too little room for two steps of "
                f"{state_bytes} bytes; point TMPDIR at a larger disk."
            )
        record["state_bytes"] = state_bytes
        begin = time.perf_counter()
        run_multiprocess(mr_save, 2, (base, out_dir), timeout_s=MR_RANK_TIMEOUT_S)
        record["world2_s"] = time.perf_counter() - begin
        saves = _mr_records(out_dir, "save", 2)
        record["world2"] = saves
        record["world2_save_gbps"] = sum(r["save_bytes"] for r in saves) / 1e9 / max(r["save_s"] for r in saves)
        record["world2_drain_gbps"] = (
            sum(r["async_bytes"] for r in saves) / 1e9 / max(r["async_drain_s"] for r in saves)
        )
        if saves[0]["all_steps"] != [2]:
            raise AssertionError(f"all_steps() is {saves[0]['all_steps']} after retention, expected [2]")
        if sum(r["local_bytes"] for r in saves) < state_bytes:
            raise AssertionError("the world-2 shards do not cover the state")

        begin = time.perf_counter()
        run_multiprocess(mr_restore, 4, (base, out_dir), timeout_s=MR_RANK_TIMEOUT_S)
        record["world4_s"] = time.perf_counter() - begin
        restores = _mr_records(out_dir, "restore", 4)
        record["world4"] = restores
        record["world4_restore_gbps"] = (
            sum(r["read_bytes"] for r in restores) / 1e9 / max(r["restore_s"] for r in restores)
        )
        record["world4_read_bytes_over_quarter_state"] = [
            r["read_bytes"] / (state_bytes / 4) for r in restores
        ]
        for r in restores:
            if r["step"] != 2 or r["progress"] != 2 or r["leaves_byte_equal"] != r["leaves"]:
                raise AssertionError(f"world-4 rank {r['rank']}: {r}")

        # World 1, this process: a plain model, and a forward through K1.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
        reference = tf.Transformer.init(cfg, seed=0)
        _mr_change(reference.params())
        model = tf.Transformer.init(cfg, seed=1)
        progress = StateDict(step=0)
        torch.cuda.synchronize()
        begin = time.perf_counter()
        step = CheckpointManager(base).restore(
            {"model": tf.TransformerState(model), "progress": progress}
        )
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - begin
        equal = sum(
            b.is_cuda and torch.equal(a.detach().view(torch.uint8), b.detach().view(torch.uint8))
            for a, b in zip(tf.param_leaves(reference.params()), tf.param_leaves(model.params()))
        )
        n_leaves = len(list(tf.param_leaves(model.params())))
        record.update(
            world1_restore_s=restore_s,
            world1_restore_gbps=state_bytes / 1e9 / restore_s,
            world1_leaves_byte_equal=equal,
            world1_leaves=n_leaves,
            world1_pool=_pool_stats(),
        )
        _restore_profile(record, "world1_restore_profile", state_bytes,
                         max(t.numel() * t.element_size() for t in tf.param_leaves(model.params())))
        if step != 2 or progress["step"] != 2 or equal != n_leaves:
            raise AssertionError(f"world-1 restore: step {step}, {equal}/{n_leaves} leaves equal")
        gen = torch.Generator(device="cuda").manual_seed(7)
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
        torch.cuda.synchronize()
        # The multi-rank path's launch counts start here.
        _reset_launch_counts()
        with torch.no_grad():
            logits = model(tokens)
        torch.cuda.synchronize()
        record["flash_launches"] = attention.flash_forward_launches
        # The multi-rank path's launch counts end here.
        with torch.no_grad():
            want = reference(tokens)
        record["logits_bit_identical"] = bool(torch.equal(logits, want))
        record["logits_finite"] = bool(torch.isfinite(logits).all())
        if record["flash_launches"] != cfg.n_layers:
            raise AssertionError(f"{record['flash_launches']} flash launches in one forward")
        if not (record["logits_bit_identical"] and record["logits_finite"]):
            raise AssertionError("logits after the elastic restore differ")
        del reference, model, logits, want
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    emit(record)
    return record


# The sequence-parallel phases: two processes on the one card in a gloo
# process group (NCCL refuses two ranks on one GPU), a {"sp": 2} mesh.
SP_WORLD = 2
SP_RANK_TIMEOUT_S = 600.0
# openai-community/gpt2-large: n_embd 1280, n_head 20, n_layer 36,
# n_inner 5120, vocab 50257, n_positions 1024. Its 20 heads divide by
# sp 2, as Ulysses needs; GPT-2 XL's 25 do not.
GPT2_LARGE = dataclasses.replace(GPT2_XL, d_model=1280, n_heads=20, n_layers=36, d_ff=5120)
# (phase, config, ring_attention mode, chunk attentions a layer a rank)
SP_PHASES = {
    "ring": (GPT2_XL, "zigzag", 5),
    "ulysses": (GPT2_LARGE, "ulysses", 1),
}


def _sp_checked_leaves(cfg):
    """The leaves whose gradients are held against the reference's."""
    return ("embed", "layers/0/attn/wq", f"layers/{cfg.n_layers - 1}/mlp/w2", "final_ln")


def _leaf_index(params, path):
    target = params
    for key in path.split("/"):
        target = target[int(key)] if key.isdigit() else target[key]
    return [id(t) for t in tf.param_leaves(params)].index(id(target))


def _sp_tokens(cfg):
    gen = torch.Generator(device="cuda").manual_seed(13)
    return torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")


def _sp_params(cfg):
    params = tf.init_params(cfg, seed=0)
    for p in tf.param_leaves(params):
        p.requires_grad_()
    return params


def sp_rank(rank, world, phase, workdir):
    """One rank of a sequence-parallel phase: the gradients of one pass
    through ``loss_and_grads`` against the one-process reference, then
    one ``sgd_train_step``, each with its launches and collective bytes."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mode, _ = SP_PHASES[phase]
    sp_cfg = dataclasses.replace(
        cfg, flash_attention=False, ring_attention=mode, ring_chunk_impl="flash"
    )
    mesh = make_mesh({"sp": world}, "cuda")
    params = _sp_params(cfg)
    tokens = _sp_tokens(cfg)
    reference = torch.load(os.path.join(workdir, "reference.pt"))
    torch.cuda.reset_peak_memory_stats()
    record = {"rank": rank, "grad_max_rel_err": {}}

    torch.cuda.synchronize()
    _reset_launch_counts()
    collectives.reset_counts()
    begin = time.perf_counter()
    loss, grads = tf.loss_and_grads(params, tokens, sp_cfg, mesh)
    record["loss"] = float(loss)  # synchronises
    record["loss_and_grads_s"] = time.perf_counter() - begin
    record["launches_loss_and_grads"] = list(_launch_counts())
    for path in _sp_checked_leaves(cfg):
        got = grads[_leaf_index(params, path)]
        want = reference["grads"][path].to(got.device)
        record["grad_max_rel_err"][path] = float((got - want).abs().max() / want.abs().max())
    del grads, got, want
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    # This rank's launch and collective counts of the step start here.
    _reset_launch_counts()
    collectives.reset_counts()
    begin = time.perf_counter()
    _, step_loss = tf.sgd_train_step(params, tokens, sp_cfg, mesh)
    record["step_loss"] = float(step_loss)  # synchronises
    record["step_s"] = time.perf_counter() - begin
    record["launches"] = list(_launch_counts())
    record["sent_bytes"] = dict(collectives.sent_bytes)
    record["staged_bytes"] = collectives.staged_bytes
    # ... and end here.
    record["peak_gb"] = _peak_gb()
    group = mesh.get_group("sp")
    record["group_backend"] = str(torch.distributed.get_backend(group))
    # The step's transport alone, on tensors of the same sizes: the
    # gradient sum over sp, and the attention's hops (the ring: K and V
    # one hop a layer each way) or all-to-alls (Ulysses: q, k, v and the
    # output, each way).
    with torch.no_grad():
        torch.cuda.synchronize()
        begin = time.perf_counter()
        for p in tf.param_leaves(params):
            collectives.all_reduce_(torch.zeros_like(p), group)
        record["grad_all_reduce_s"] = time.perf_counter() - begin
        heads = cfg.n_heads
        piece = torch.zeros((BATCH, heads, SEQ // world, cfg.d_model // heads), device="cuda")
        begin = time.perf_counter()
        for _ in range(2 * cfg.n_layers):
            if mode == "ulysses":
                for _ in range(4):
                    collectives.all_to_all(piece, group, split_dim=1, concat_dim=2)
            else:
                collectives.rotate(piece, piece, group=group)
        torch.cuda.synchronize()
        record["attention_traffic_s"] = time.perf_counter() - begin
    with open(os.path.join(workdir, f"{phase}_{rank}.json"), "w") as f:
        json.dump(record, f)


def phase_seq_parallel(phase):
    """The flagship at the phase's published widths and full depth,
    f32, 4 × 1024 tokens: the reference is one process's flash step on
    the same weights and tokens (run first and freed, so the ranks get
    the card to themselves); then two ranks train one step over
    ``{"sp": 2}`` with the phase's sequence-parallel attention, flash
    chunks through K1–K3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(False)
    cfg, mode, chunks_per_layer = SP_PHASES[phase]
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}-")
    record = {
        "phase": phase,
        "model": f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_layers} layers, "
                 f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, f32",
        "ring_attention": mode,
        "ring_chunk_impl": "flash",
        "mesh": {"sp": SP_WORLD},
        "tokens": [BATCH, SEQ],
    }
    try:
        params = _sp_params(cfg)
        tokens = _sp_tokens(cfg)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        begin = time.perf_counter()
        loss, grads = tf.loss_and_grads(params, tokens, cfg)
        record["reference_loss"] = float(loss)
        record["reference_s"] = time.perf_counter() - begin
        record["reference_peak_gb"] = _peak_gb()
        torch.save(
            {"grads": {p: grads[_leaf_index(params, p)].cpu() for p in _sp_checked_leaves(cfg)}},
            os.path.join(workdir, "reference.pt"),
        )
        del params, grads, loss
        torch.cuda.empty_cache()

        begin = time.perf_counter()
        run_multiprocess(sp_rank, SP_WORLD, (phase, workdir), timeout_s=SP_RANK_TIMEOUT_S)
        record["spawned_world_s"] = time.perf_counter() - begin
        ranks = _mr_records(workdir, phase, SP_WORLD)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record["ranks"] = ranks
    expected = [chunks_per_layer * cfg.n_layers] * 3
    record["expected_launches"] = expected
    record["grad_rel_bound"] = 1e-3
    record["loss_rtol"] = 1e-4
    emit(record)
    losses = {r["loss"] for r in ranks} | {r["step_loss"] for r in ranks}
    if len(losses) != 1:
        raise AssertionError(f"{phase}: the ranks' losses differ: {sorted(losses)}")
    loss = losses.pop()
    if not abs(loss - record["reference_loss"]) <= 1e-4 * abs(record["reference_loss"]):
        raise AssertionError(f"{phase}: loss {loss} against the reference {record['reference_loss']}")
    for r in ranks:
        worst = max(r["grad_max_rel_err"].values())
        if not worst <= 1e-3:
            raise AssertionError(f"{phase} rank {r['rank']}: gradients off by {r['grad_max_rel_err']}")
        if r["launches"] != expected or r["launches_loss_and_grads"] != expected:
            raise AssertionError(
                f"{phase} rank {r['rank']}: K1/K2/K3 launched {r['launches_loss_and_grads']} "
                f"and {r['launches']} times; expected {expected} each pass")
    return record


def _gpt2_xl_shapes(cfg):
    d, f = cfg.d_model, cfg.d_ff
    layer = [(d, d)] * 4 + [(d, f), (f, d), (d,), (d,)]
    return [(cfg.vocab_size, d), (cfg.max_seq_len, d), (d,)] + layer * cfg.n_layers


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available.", file=sys.stderr)
        return 2
    smi, device = phase_device()
    phase_build()
    flash = phase_kernel()
    flash_bwd = phase_kernel_bwd()
    transfer_record = phase_transfer()
    fingerprint = phase_kernel_fingerprint()
    main_path, model, tokens = phase_main_path(transfer_record["h2d_pinned_gbps"])
    dedup = phase_dedup(model, tokens)
    del model, tokens
    torch.cuda.empty_cache()
    phase_torn_leaf()
    train = phase_train()
    multi_rank = phase_multi_rank()
    sp_paths = {phase: phase_seq_parallel(phase) for phase in SP_PHASES}
    fwd = flash["main_path"]
    bwd = flash_bwd["train_path"]

    def chunk_row(record, ms_key, bound_key):
        """A kernel's numbers at the ring's causal chunk shape."""
        return {"ms": record[ms_key], "plain_ms": record["plain_ms"],
                "bound_ms": record[bound_key], "library_ms": record["library_ms"],
                "max_abs_err": record["max_abs_err"]}

    def sp_launches(i):
        """Rank 0's launches of kernel i in one step of each sp path."""
        return {f"launches_{phase}_path": rec["ranks"][0]["launches"][i]
                for phase, rec in sp_paths.items()}

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "torchsnapshot_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "torchsnapshot_tpu/ops/attention.py:103",
        "launches": train["launches"]["flash_fwd"],
        "launches_forward_path": main_path["flash_launches"],
        "launches_multi_rank_path": multi_rank["flash_launches"],
        **sp_launches(0),
        "ring_chunk": chunk_row(flash["ring_chunk_causal"], "kernel_ms", "bound_ms"),
        "max_abs_err": fwd["max_abs_err"],
        "ms": fwd["kernel_ms"],
        "kernel_ms": fwd["kernel_ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
    }]
    for i, (name, key, line) in enumerate(
        (("flash_bwd_dq", "dq", 199), ("flash_bwd_dkv", "dkv", 230)), start=1
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "torchsnapshot_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"torchsnapshot_tpu/ops/attention.py:{line}",
            "launches": train["launches"][name],
            **sp_launches(i),
            "ring_chunk": chunk_row(flash_bwd["ring_chunk_causal"], f"{key}_kernel_ms", f"{key}_bound_ms"),
            "ring_chunk_dlse_max_abs_err": flash_bwd["ring_chunk_dlse"]["max_abs_err"],
            "max_abs_err": bwd["max_abs_err"],
            "ms": bwd[f"{key}_kernel_ms"],
            "kernel_ms": bwd[f"{key}_kernel_ms"],
            # The plain backward and SDPA's backward compute the pair.
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{key}_bound_ms"],
            "bound_by": bwd[f"{key}_bound_by"],
            "library_ms": bwd["library_ms"],
        })
    for name, key, line in (("xs128_box", "k4", 123), ("xs128_chunked", "k5", 219)):
        w1, embed, state = (fingerprint["timings"][k] for k in ("w1", "embed", "state"))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "torchsnapshot_tpu_torch/csrc/fingerprint.cu",
            "replaces": f"torchsnapshot_tpu/fingerprint.py:{line}",
            "launches": dedup["launches"][name],
            "max_abs_err": fingerprint["max_abs_err"],
            # At the 40.96 MB w1; the embed and the whole state beside it.
            "ms": w1[f"{key}_ms"],
            "plain_ms": w1[f"{key}_plain_ms"],
            "bound_ms": w1["bound_ms"],
            "bound_by": w1["bound_by"],
            "bytes_bound_ms": w1["bytes_bound_ms"],
            "integer_bound_ms": w1["integer_bound_ms"],
            "library_ms": None,
            "hbm_reference_int32_sum_ms": w1["int32_sum_ms"],
            "embed": {"ms": embed[f"{key}_ms"], "plain_ms": embed[f"{key}_plain_ms"],
                      "bound_ms": embed["bound_ms"], "int32_sum_ms": embed["int32_sum_ms"]},
            "state": {"ms": state[f"{key}_ms"], "plain_ms": state[f"{key}_plain_ms"],
                      "bound_ms": state["bound_ms"],
                      "bytes_bound_ms": state["bytes_bound_ms"],
                      "integer_bound_ms": state["integer_bound_ms"],
                      "int32_sum_ms": state["int32_sum_ms"]},
            "pipe_ops_per_word": fingerprint["pipe_ops_per_word"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device["kind"], "count": device["count"]},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
