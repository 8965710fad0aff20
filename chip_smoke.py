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
   path's chunk ([4,25,256,64] f32, causal and full), the Ulysses
   path's full-sequence attention ([4,10,1024,64] f32) and the dry run's
   ring chunk ([2,2,16,16] f32, head_dim 16, causal and full).
4. kernel_bwd — the two flash backward kernels (dq; dk and dv) against
   the plain backward at the train path's shape and the shapes around
   it (f32, bf16, f16; causal or not; GQA; ragged S; head_dim 128 and
   80), with the tolerance stated, a check that two launches give
   bitwise-equal results, each kernel's time and bound, the plain
   version's time and, as the pair's yardstick, the backward of
   ``scaled_dot_product_attention`` on the same inputs. The ring,
   Ulysses and dry-run shapes are among them, and one ring-chunk case
   of the ring and of the dry run each goes through
   ``flash_attention_backward`` with a non-zero lse cotangent, against the
   plain backward with the same delta' = rowsum(dO·O) − dlse.
5. transfer — pinned device→host and host→device copy rates over 1 GiB,
   and the rate at which fresh host memory is pinned.
5b. kernel_fingerprint — the batched xs128 kernels K4 (tensors, or boxes
   of them read as runs in place) and K5 (per chunk), one launch a
   batch, against their plain versions, run on the card, and the host
   fingerprint, bit for bit: nine dtypes from bool to f64, empty and odd
   lengths, 1-byte views at odd offsets, boxes along either dim, chunk
   sizes that do not divide, each a batch of one launched twice; one K4
   batch of them all with a tensor given twice, K5 batches over leaves
   of different chunk counts, a batch split between the fast and the
   general path. Then their times at the 40.96 MB w1, the 321.6 MB embed
   and the 387 leaves of the state, each one batch (the prepared launch
   alone, and the wrapper called from a list of tensors), beside the
   byte bound, the integer bound (the busier pipe's SASS instructions of
   the accumulate loop, the weight block and the general loop, from
   ``cuobjdump``, times the batch's words and weight indices), the plain
   version's time and ``x.view(torch.int32).sum()`` over the same bytes
   as an HBM yardstick (no PyTorch call computes xs128).
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
   unchanged state (0 array bytes written, 0 bytes device→host, K4 over
   every leaf in one launch), an in-place change to two whole layers and the first
   1,000 rows of ``embed``, an incremental take writing exactly those 17
   leaves, a ``verify_device=True`` restore into a fresh model with
   bit-identical logits; three ``chunks=True`` takes (the state; the
   unchanged state, 0 chunk objects; after the same change again, exactly
   the touched chunks of the 4 MiB grid), a restore of the last with
   bit-identical logits, and deletes of the middle (every chunk shared:
   none freed) and the first (its exclusive chunks freed). Each take
   prints its seconds, payload bytes and objects written, chunk objects
   stored, bytes copied to the host and the K4/K5 milliseconds within it.
6c. api — on the same model: a take with fingerprints, ``verify()``
   (clean; seconds and GB/s beside the filesystem's read rate),
   ``copy_to`` with ``verify=True`` (beside the write+fsync rate), an
   in-place change to layers 10 and 20 and an incremental take, ``diff``
   (exactly the 16 changed leaves, no payload byte read), a
   ``restore(paths=["model/layers/10/**"], verify_device=True)`` into a
   fresh model (exactly the 8 selected leaves' bytes read, K4 over each
   in one launch, every other leaf's storage and bytes as they were), a
   ``paths=["**"]`` restore of the copy with bit-identical K1 logits, one
   byte flipped in the copy (``verify()`` names that object alone;
   ``copy_to`` from it raises and leaves no metadata), and the inspect CLI
   in a subprocess (``--verify``: exit 1 naming the object; ``--diff``:
   exit 1 with the changed leaves).
6b. torn leaf — a copy of a small chunked snapshot with one corrupt
   chunk, then an injected failure of an H2D pipeline transfer, then a
   20 MiB single-object leaf (two staging-slot transfers) whose second
   transfer fails, each restored into a CUDA template of other values:
   all raise and leave the template bit-equal to its old values; the
   retries are bit-exact.
6d. faults — faultline at the same width, on the same model (after api):
   the op boundaries of one fault-free cycle of a
   ``CheckpointManager(max_to_keep=1, chunks=True)`` (one layer changed
   in place, the next step saved, the step before pruned with chunk GC)
   are counted, and a cycle crashes at 6 of them (the first, the last,
   stride total//5 between); after each crash ``check_recovery_invariant``
   holds every marked and adopted step to ``verify()`` and to a
   ``verify_device`` restore into a CUDA template (K4 on every leaf),
   byte-equal to that step's values, and the re-drive (the next save,
   ``reconcile``, ``assert_reclaimed``) leaves only the new step. Then a
   torn write (the save fails, the truncated object is on disk, the step
   is invisible and reclaimed), a crash at the 8th chunk read of a
   restore (the CUDA template keeps every byte), 503s on about every 10th
   write of an unchunked take (completed through the retry policy,
   restored byte-equal), and a world-2 gloo take with rank 1's publishes
   muted (rank 0's TimeoutError names rank 1 within the 20 s deadline).
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
9. ring — the flagship at GPT-2 XL's widths and depth (48 layers), f32,
   4 × 1024 tokens, trained one step by two processes
   sharing the card over gloo on a ``{"sp": 2}`` DeviceMesh: zigzag ring
   attention with flash chunks, so K1–K3 run as chunk kernels (5 chunk
   attentions a layer a rank: 240 launches of each kernel a step). The
   reference is one process's flash step on the same weights and
   tokens, run first: the ranks' losses are equal and within rtol 1e-4 of it, and the gradients
   of ``embed``, ``layers/0/attn/wq``, the last layer's ``mlp/w2`` and
   ``final_ln`` within 1e-3 of each one's largest reference entry. Each
   rank reports its step time, the bytes it sent through the ring and
   the other collectives, how many were staged through host memory (the
   helpers stage CUDA tensors on a gloo group), its peak card memory,
   and the step's transport alone: the gradient all-reduce, and the
   hops (or all-to-alls) on tensors of the same sizes.
10. ulysses — the same at gpt2-large's widths and depth (n_embd 1280,
    20 heads, 36 layers, n_inner 5120: GPT-2 XL's 25 heads do not divide
    by sp 2), with Ulysses all-to-all attention through the flash kernels
    (36 launches of each a step).
11. dlrm — DLRM at the Criteo Kaggle widths of facebookresearch/dlrm's
    bench/dlrm_s_criteo_kaggle.sh (embedding 16, bottom MLP
    13-512-256-64-16, top 367-512-256-1, batch 128, lr 0.1) with the 26
    Kaggle row counts torchrec's DLRM example lists (33,762,577 rows;
    params and momentum 4.33 GB, f32, nothing cut), one process: 5
    momentum steps, a sync take, a restore (bit-exact, bit-identical
    logits), ``convert_back`` and a ``ReferenceSnapshotReader`` restore
    and read, two chunk takes around a step (exactly the changed chunks;
    K5), a ``verify_device`` restore (K4); then K4 on every leaf and on
    the stored boxes of the two leaves above the dense-chunk cap, and K5
    on every leaf, held bit for bit against their plain versions.
12. dlrm_ep — the same at ep 2 (two processes sharing the card over
    gloo): one step (loss within rtol 1e-5 of one process), a take (bytes
    a rank), a world-1 restore bit-exact in every box.
13. resnet — the JAX CNN at ResNet-18's widths on CIFAR-10's shapes,
    batch 128: 5 steps, take and restore (BN statistics included), a dp-2
    step held to one process and to a float64 step, a replicated take.
    ``tools/resnet_dp_faults.py`` runs the same phase with the dp step's
    faults injected, to read how far the gates sit from them.
14. ddp — the reference DDP benchmark's model (20 × 100 MiB) taken
    replicated by two ranks, each writing half, restored bit-exact.
15. dryrun — ``dryrun.dryrun_multichip(2)``: K1–K3 as ring chunks, K4.
16. examples — the six scripts of ``examples_torch/`` on the card, each a
    subprocess (three at a time) that must exit 0 and print its lines; K1
    launches from the long-context script, K4's launches and leaves from
    the incremental one.
17. phase seconds — one JSON line with each phase's wall seconds.
18. kernels — one JSON line summarising every kernel of the paths (K4
    and K5 with their launches and segments on the dedup, api, dlrm,
    dryrun, faults and examples paths, K1 with its launches on each).

The last line is ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero, as does a host without CUDA.

Float32 matrix products run at full float32 precision (TF32 off), and
deterministic algorithms are on in the main path (with
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts), so two forward
passes over the same bytes give bit-identical logits. The train path
claims no bit-identity and turns them off.
"""

import contextlib
import ctypes
import dataclasses
import glob
import importlib.util
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
from torchsnapshot_tpu_torch import dryrun, io_preparer, staging_pool  # noqa: E402
from torchsnapshot_tpu_torch.io_types import io_payload  # noqa: E402
from torchsnapshot_tpu_torch import snapshot as snapshot_mod  # noqa: E402
from torchsnapshot_tpu_torch.manifest import ArrayEntry, ShardedArrayEntry  # noqa: E402
from torchsnapshot_tpu_torch.models import dlrm, resnet, transformer as tf  # noqa: E402
from torchsnapshot_tpu_torch.models.ddp_synthetic import SyntheticModel  # noqa: E402
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
    # The dry run's ring chunks at world 2 (dp 1, sp 1, tp 2; 32 tokens,
    # d_model 64 over 4 heads): 2 heads a rank, head_dim 16, 16-row
    # zigzag halves, causal on the diagonal and full on the past.
    ("dryrun_chunk_causal", 2, 2, 2, 16, 16, torch.float32, True),
    ("dryrun_chunk_full", 2, 2, 2, 16, 16, torch.float32, False),
    # The long-context example's ring chunks on a card (sp 2, 1024
    # tokens, 4 heads of 32): 256-row zigzag halves, causal on the
    # diagonal and full on the past.
    ("examples_chunk_causal", 1, 4, 4, 256, 32, torch.float32, True),
    ("examples_chunk_full", 1, 4, 4, 256, 32, torch.float32, False),
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
    ("dryrun_chunk_causal", 2, 2, 2, 16, 16, torch.float32, True),
    ("dryrun_chunk_full", 2, 2, 2, 16, 16, torch.float32, False),
    ("dryrun_chunk_dlse", 2, 2, 2, 16, 16, torch.float32, False),
    # The long-context example's backward: both of its chunks get an lse
    # cotangent from the merge.
    ("examples_chunk_causal", 1, 4, 4, 256, 32, torch.float32, True),
    ("examples_chunk_full", 1, 4, 4, 256, 32, torch.float32, False),
    ("examples_chunk_dlse", 1, 4, 4, 256, 32, torch.float32, False),
    ("examples_chunk_causal_dlse", 1, 4, 4, 256, 32, torch.float32, True),
]
# Cases whose lse cotangent is not zero, as a ring chunk's is (the merge
# differentiates through the lse): they go through flash_attention_backward
# with a d_lse, whose delta' = rowsum(dO·O) − dlse the plain backward gets.
DLSE_CASES = {"ring_chunk_dlse", "dryrun_chunk_dlse", "examples_chunk_dlse",
              "examples_chunk_causal_dlse"}

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


def _hold(phase, gates):
    """Raise naming every gate of ``phase`` that failed."""
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} phase: {failed}")


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


# xs128 (K4, K5). The payload bytes are read once. One launch covers a
# batch of segments: the fast path computes the weights of a tile of
# 2,048 word indices once and sums every segment of its group that
# reaches the tile; the general path computes each word's weights
# itself. Instructions issue on two pipes of 64 lanes an SM each (132 SMs
# at the 1.98 GHz boost clock of the data sheet, whose 67 TFLOP/s f32 is
# 128 lanes × 2): IMAD, IMUL and VIADD on the FMA pipe, the shifts, LOP3s,
# adds and the rest on the integer ALU pipe. The integer bound counts the
# operations the function needs, not the kernel's loops: the weights of
# every distinct word index of the batch once (the weight block's SASS
# counts an index, read at run time), and four multiply-adds a word (one
# a lane) on the FMA pipe; the busier pipe at 64 lanes × 132 SMs ×
# 1.98e9 a second.
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Without SASS: the source's count of a weight index (four mix32s and
# the index's multiply), split evenly over the two pipes.
FP_SOURCE_WEIGHT_OPS = {"fma_pipe": 40 / 2, "alu_pipe": 40 / 2}
FP_PATHS = ("accumulate", "weights", "lone", "general")
FP_FMA_PIPE = ("IMAD", "IMUL", "VIADD")
FP_CHUNK_BYTES = 4 << 20  # the chunk store's default grid
FP_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.float16, torch.bfloat16,
             torch.float32, torch.int32, torch.int64, torch.float64]
FP_SASS_DUMP = os.path.join(ROOT, "build", "fingerprint_sass.txt")


def _pipe_counts(instrs):
    """(FMA-pipe, ALU-pipe, opcode counts) of SASS instruction texts;
    branches and NOPs on neither."""
    ops = {}
    for x in instrs:
        op = (x.split()[1] if x.startswith("@") else x.split()[0]).split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    fma = sum(n for op, n in ops.items() if op in FP_FMA_PIPE)
    alu = sum(n for op, n in ops.items() if op not in FP_FMA_PIPE and op not in ("BRA", "NOP"))
    return fma, alu, ops


def _sass_loops():
    """The batched K4/K5 kernel's instruction counts from ``cuobjdump
    -sass`` of the built library: the fast path's accumulate loop per word
    (a tile's words a thread a trip), the straight-line block before it,
    where the tile's weights are computed, per index (as many a thread),
    the lone loop per word (as many a trip) and the general path's word
    loop per word (its 4-byte loads a trip). Each
    with the FMA and ALU pipes apart. None where cuobjdump is missing or
    the loops are not found; the kernel's SASS is written to
    ``build/fingerprint_sass.txt``."""
    import re

    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(build._library_path("fingerprint"))
    try:
        sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        if "xs128_batch_kernel" not in name:
            continue
        os.makedirs(os.path.dirname(FP_SASS_DUMP), exist_ok=True)
        with open(FP_SASS_DUMP, "w") as f:
            f.write(body)
        labels, instrs, pending = {}, [], []
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
        back = []  # (branch address, target address) of every backward branch
        for addr, text in instrs:
            t = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
            if t:
                target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
                if target is not None and target < addr:
                    back.append((addr, target))

        def body_of(lo, hi):
            return [x for a, x in instrs if lo <= a <= hi and not x.startswith("NOP")]

        def n_loads(loop, wide):
            return sum(1 for x in loop if "LDG" in x and (".128" in x) == wide and ".U8" not in x)

        # The accumulate loop: the innermost loop with 16-byte loads (the
        # fast path's walk over a tile's segments; both of its load
        # branches are counted, the masked one runs only in a segment's
        # last tile). The weights: the straight-line block before it, from
        # the tile loop's head. The lone loop: the longest other loop with
        # 16-byte loads that does not hold it (a lone segment's tiles,
        # each word's weights computed for it). The general loop: the longest loop with 4-byte
        # loads and no 16-byte ones.
        loops = [(t, a) for a, t in back]
        wide = [(t, a) for t, a in loops if n_loads(body_of(t, a), True)]
        narrow = [(t, a) for t, a in loops if n_loads(body_of(t, a), False) and not n_loads(body_of(t, a), True)]
        if not wide or not narrow:
            return None
        acc_top, acc_end = min(wide, key=lambda ta: ta[1] - ta[0])
        acc = body_of(acc_top, acc_end)
        lone = max((body_of(t, a) for t, a in wide if a < acc_top or t > acc_end), key=len, default=None)
        if lone is None:
            return None
        gen = max((body_of(t, a) for t, a in narrow), key=len)
        marks = [a for t, a in loops if a < acc_top] + [t for t, a in loops if t < acc_top]
        head = max(marks, default=instrs[0][0])
        weights = [x for a, x in instrs if head <= a < acc_top and not x.startswith("NOP")]
        out = {"kernel": name.strip()}
        per_thread = fops.TILE_WORDS // 256  # words (and weight indices) a thread a tile
        for key, loop, per in (("accumulate", acc, per_thread), ("weights", weights, per_thread),
                               ("lone", lone, per_thread),
                               ("general", gen, n_loads(gen, False))):
            fma, alu, ops = _pipe_counts(loop)
            out[key] = {"instructions": len(loop), "per": per, "fma_pipe": fma / per, "alu_pipe": alu / per,
                        "opcodes": ops}
        return out
    return None


def _fp_weight_ops(sass):
    """{pipe: instructions a weight index}: the weight block's SASS where
    it was read, else the source's count."""
    if sass is None:
        return dict(FP_SOURCE_WEIGHT_OPS)
    return {pipe: sass["weights"][pipe] for pipe in ("fma_pipe", "alu_pipe")}


def _fp_bound(nbytes, plan, weight_ops):
    """(bound ms, "bytes" or "operations", byte ms, integer ms) of one
    batch: the bytes once at HBM rate; the busier pipe's operations for
    the weights of the batch's distinct word indices (the longest
    segment's words: indices restart at each segment) and four
    multiply-adds a word."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    sec = plan.sections()
    distinct = max(4 * int(sec["fast_vecs"].max(initial=0)), int(sec["gen_w1"].max(initial=0)))
    words = plan.fast_words + plan.general_words
    ops = max(weight_ops["alu_pipe"] * distinct, weight_ops["fma_pipe"] * distinct + 4 * words)
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms else "bytes", bytes_ms, ops_ms)


def _lanes_err(a, b):
    """Largest |a - b| over the u32 lanes of two int32 result tensors."""
    ua = a.cpu().numpy().view("uint32").astype("int64")
    ub = b.cpu().numpy().view("uint32").astype("int64")
    return int(abs(ua - ub).max()) if ua.size else 0


def _fp_input(gen, dtype, n):
    if dtype == torch.bool:
        return torch.rand(n, generator=gen, device="cuda") > 0.5
    if dtype.is_floating_point:
        return torch.randn(n, generator=gen, device="cuda").to(dtype)
    return torch.randint(-100, 100, (n,), generator=gen, device="cuda").to(dtype)


def phase_kernel_fingerprint():
    """The batched K4 and K5 against their plain versions (run on the
    card) and the host twins, bit for bit: every dtype of the tests at
    their edges (empty, odd lengths, 1-byte views at odd offsets, one-dim
    boxes, chunk sizes that do not divide), each a batch of one launched
    twice; then one K4 batch of all of them with one tensor given twice,
    one K5 batch over leaves whose chunk counts differ, and a batch split
    between the fast and the general path. Then the times at the dedup
    path's shapes (w1, embed, the 387 state leaves) as one batch each:
    the prepared launch alone and the wrapper called from a list of
    tensors (the host's table build and copy counted), beside the byte
    bound and the integer bound, the plain version's time and the
    int32-sum HBM reference; the wrappers' results there held bit for
    bit against the plain versions too."""
    from torchsnapshot_tpu_torch import fingerprint as fp
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    gen = torch.Generator(device="cuda").manual_seed(29)
    cases, worst = 0, 0
    failures = []

    def box_host(x, box):
        return (x if box is None else x[tuple(slice(a, b) for a, b in box)]).contiguous().cpu()

    def check_boxes(name, items):
        nonlocal cases, worst
        launches = fops.fingerprint_box_launches
        outs = [fops.fingerprint_boxes(items) for _ in range(2)]
        launched = fops.fingerprint_box_launches - launches
        plain = torch.stack([fops.fingerprint_box_reference(x, box) for x, box in items])
        want = [fp.fingerprint_host(box_host(x, box)) for x, box in items]
        got = [fp.resolve_fingerprints(list(o)) for o in outs]
        torch.cuda.synchronize()
        err = max(_lanes_err(o, plain) for o in outs)
        worst = max(worst, err)
        cases += len(items)
        nonempty = any(box_host(x, box).numel() for x, box in items)
        if err or got[0] != got[-1] or got[0] != want or launched != (2 if nonempty else 0):
            failures.append(name)

    def check_chunked(name, items, chunk_bytes):
        nonlocal cases, worst
        launches = fops.fingerprint_chunked_launches
        outs = [fops.fingerprint_chunked_many(items, chunk_bytes) for _ in range(2)]
        launched = fops.fingerprint_chunked_launches - launches
        sizes = [chunk_bytes] * len(items) if isinstance(chunk_bytes, int) else chunk_bytes
        plain = [fops.fingerprint_chunked_reference(x, cb) for x, cb in zip(items, sizes)]
        want = [fp.fingerprint_host_chunked(x.cpu(), cb) for x, cb in zip(items, sizes)]
        got = [fp.resolve_chunk_fingerprints(o) for o in outs]
        torch.cuda.synchronize()
        err = max(_lanes_err(o, p) for out in outs for o, p in zip(out, plain))
        worst = max(worst, err)
        cases += len(items)
        nonempty = any(x.numel() for x in items)
        if err or got[0] != got[-1] or got[0] != want or launched != (2 if nonempty else 0):
            failures.append(name)

    batch_items = []
    for dtype in FP_DTYPES:
        for n in (0, 1, 3, 13, 4097, (1 << 20) + 3):
            x = _fp_input(gen, dtype, n)
            batch_items.append((x, None))
            check_boxes(f"k4_{dtype}_{n}", [(x, None)])
            for cb in (12, 4096):
                check_chunked(f"k5_{dtype}_{n}_{cb}", [x], cb)
    base = torch.randint(-100, 100, (100003,), generator=gen, device="cuda").to(torch.int8)
    for offset in (1, 2, 3):
        batch_items.append((base[offset:], None))
        check_boxes(f"k4_offset_{offset}", [(base[offset:], None)])
        check_chunked(f"k5_offset_{offset}", [base[offset:]], 4096)
    for dtype in (torch.float32, torch.float16, torch.int8):
        m = torch.randn(64, 129, generator=gen, device="cuda").to(dtype)
        for box in ([(3, 40), (0, 129)], [(0, 64), (5, 77)], [(0, 64), (1, 2)]):
            batch_items.append((m, box))
            check_boxes(f"k4_box_{dtype}_{box}", [(m, box)])
    # One batch of every case above, one tensor given twice.
    batch_items.append(batch_items[len(batch_items) // 2])
    check_boxes("k4_mixed_batch", batch_items)
    chunk_leaves = [_fp_input(gen, torch.float32, n) for n in (3 << 20, 5 << 18, 1 << 20, 777, 0)]
    chunk_leaves += [base[1:], _fp_input(gen, torch.bfloat16, (1 << 21) + 1)]
    check_chunked("k5_mixed_batch", chunk_leaves, 1 << 20)
    check_chunked("k5_mixed_batch_per_leaf_sizes", chunk_leaves, [4096, 1 << 20, 4100, 12, 4096, 4096, 1 << 16])
    # Fast and general segments in one launch: aligned leaves with and
    # without 16-byte tails, offset views, runs of a box.
    m = torch.randn(300, 1001, generator=gen, device="cuda")
    split_items = [(_fp_input(gen, torch.float32, (1 << 20) + 3), None), (m, None), (m, [(0, 300), (7, 500)]),
                   (base[3:], None), (m, [(10, 290), (0, 1001)])]
    split_plan = fops.prepare_boxes(split_items).plan
    check_boxes("k4_fast_and_general", split_items)
    split = {"n_fast": split_plan.n_fast, "n_general": split_plan.n_general,
             "fast_words": split_plan.fast_words, "general_words": split_plan.general_words}
    if not (split_plan.n_fast and split_plan.n_general):
        failures.append("k4_fast_and_general did not split")

    sass = _sass_loops()
    weight_ops = _fp_weight_ops(sass)
    shapes = {"state": _gpt2_xl_shapes(GPT2_XL), "w1": [(GPT2_XL.d_model, GPT2_XL.d_ff)],
              "embed": [(GPT2_XL.vocab_size, GPT2_XL.d_model)]}
    timings = {}
    for name, leaf_shapes in shapes.items():
        leaves = [torch.randn(s, generator=gen, device="cuda") for s in leaf_shapes]
        nbytes = sum(t.numel() * 4 for t in leaves)
        k4 = fops.prepare_boxes([(t, None) for t in leaves])
        k5 = fops.prepare_chunked(leaves, FP_CHUNK_BYTES)[0]
        row = {"leaves": len(leaves), "bytes": nbytes,
               "k4_ms": cuda_ms(lambda: _checked(k4.launch()), 10),
               "k5_ms": cuda_ms(lambda: _checked(k5.launch()), 10),
               "k4_call_ms": cuda_ms(lambda: fops.fingerprint_boxes([(t, None) for t in leaves]), 10),
               "k5_call_ms": cuda_ms(lambda: fops.fingerprint_chunked_many(leaves, FP_CHUNK_BYTES), 10),
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
        got4 = fops.fingerprint_boxes([(t, None) for t in leaves])
        got5 = fops.fingerprint_chunked_many(leaves, FP_CHUNK_BYTES)
        torch.cuda.synchronize()
        row["k4_max_abs_err"] = max(_lanes_err(g, w) for g, w in zip(got4, plain["k4"]))
        row["k5_max_abs_err"] = max(_lanes_err(g, w) for g, w in zip(got5, plain["k5"]))
        cases += 2 * len(leaves)
        worst = max(worst, row["k4_max_abs_err"], row["k5_max_abs_err"])
        if row["k4_max_abs_err"] or row["k5_max_abs_err"]:
            failures.append(f"path_shapes_{name}")
        for key, batch in (("k4", k4), ("k5", k5)):
            p = batch.plan
            row[f"{key}_plan"] = {"segments": p.n_fast + p.n_general, "n_fast": p.n_fast, "groups": p.n_groups,
                                  "n_general": p.n_general, "blocks": p.fast_blocks + p.general_blocks,
                                  "fast_words": p.fast_words, "weight_indices": p.weight_indices,
                                  "lone_words": p.lone_words, "general_words": p.general_words}
            (row[f"{key}_bound_ms"], row[f"{key}_bound_by"], row["bytes_bound_ms"],
             row[f"{key}_integer_bound_ms"]) = _fp_bound(nbytes, p, weight_ops)
            row[f"{key}_gbps"] = nbytes / 1e6 / row[f"{key}_ms"]
        print(f"kernel_fingerprint: {name}: K4 {row['k4_ms']:.4f} ms ({row['k4_call_ms']:.4f} called), "
              f"K5 {row['k5_ms']:.4f} ms ({row['k5_call_ms']:.4f} called), bytes bound "
              f"{row['bytes_bound_ms']:.4f}, integer bound K4 {row['k4_integer_bound_ms']:.4f} "
              f"K5 {row['k5_integer_bound_ms']:.4f}", flush=True)
        timings[name] = row
        del leaves, k4, k5, plain, got4, got5
        torch.cuda.empty_cache()
    record = {"phase": "kernel_fingerprint", "cases": cases, "max_abs_err": worst,
              "failures": failures, "fast_and_general_batch": split,
              "sass": sass, "ops_source": "sass" if sass else "source count",
              "peak_int32_ops_per_s": PEAK_INT32_OPS_PER_S, "timings": timings}
    emit(record)
    if failures or worst:
        raise AssertionError(f"the fingerprint kernels disagree: {failures[:10]}, max err {worst}")
    return record


class _TakeMeter:
    """What one take moved: payload bytes written and objects stored
    (chunk objects apart), bytes copied device→host, the device time of
    the fingerprint kernels it launched (CUDA events around each batched
    launch), their launches and the leaves they fingerprinted."""

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
        self._fops = fops
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
        fops = self._fops
        segments = (fops.fingerprint_box_segments, fops.fingerprint_chunked_segments)
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
            "k4_segments": fops.fingerprint_box_segments - segments[0],
            "k5_segments": fops.fingerprint_chunked_segments - segments[1],
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
    bytes copied to the host, K4 over every leaf in one launch); an in-place change
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
            counts = _fp_counts()
            restored = fresh_restore(os.path.join(inc, "changed"), verify_device=True)
            record["verify_device_restore_s"] = time.perf_counter() - begin
            record["verify_device"] = {**snapshot_mod._last_verify_stats, **_fp_delta(counts, "k4")}
            record["verify_device_restore_profile"] = _dedup_profile()
            record["verify_device_logits_bit_identical"] = bool(torch.equal(restored, logits_changed))
            del restored

            # Each chunk take runs K5 over every leaf above the store's size
            # floor in one launch; the first also probes K5 once a dtype.
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
        record["segments"] = {"xs128_box": fops.fingerprint_box_segments,
                              "xs128_chunked": fops.fingerprint_chunked_segments}

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
    takes = ("full_take", "incremental_unchanged", "incremental_changed")
    gates = {
        "full take fingerprints every leaf": record["full_take"]["k4_segments"] == n,
        "unchanged take writes no array byte": unchanged["payload_bytes_written"] == 0,
        "unchanged take copies no byte to the host": unchanged["d2h_bytes"] == 0,
        "unchanged take fingerprints every leaf with K4": unchanged["k4_segments"] == n,
        "each incremental take and the verify_device restore launch K4 once": [
            record[k]["k4_launches"] for k in takes] + [record["verify_device"]["k4_launches"]] == [1] * 4,
        "changed take writes exactly the changed leaves": changed_take["payload_bytes_written"] == predicted
        and changed_take["payload_objects_written"] == len(changed),
        "verify_device restore is bit-identical": record["verify_device_logits_bit_identical"],
        "verify_device verifies every leaf with K4": record["verify_device"]
        == {"verified": n, "skipped": 0, "k4_launches": 1, "k4_segments": n},
        "every chunk take chunks every eligible leaf": all(
            c == len(eligible) for c in record["chunked_leaves"].values()),
        "chunk takes run K5 over every eligible leaf": [
            record[f"chunk_take_{s}"]["k5_segments"] for s in (1, 2, 3)]
        == [len(eligible) + probes, len(eligible), len(eligible)],
        "each chunk take launches K5 once, beside the first take's dtype probes": [
            record[f"chunk_take_{s}"]["k5_launches"] for s in (1, 2, 3)] == [1 + probes, 1, 1],
        "first chunk take stores the state": record["chunk_take_1"]["chunk_bytes_stored"] > 0.99 * state_bytes,
        "unchanged chunk take stores no chunk": record["chunk_take_2"]["chunk_objects_stored"] == 0,
        "changed chunk take stores the touched chunks": record["chunk_take_3"]["chunk_objects_stored"] == touched,
        "chunked restore is bit-identical": record["chunk_logits_bit_identical"],
        "deleting the middle frees nothing shared": after_middle == before,
        "deleting the first frees its exclusive chunks": after_first == keys[3]
        and len(before) - len(after_first) == len(keys[1] - keys[3]),
        "K4 and K5 ran on the path": all(record["launches"].values()),
    }
    _hold("dedup", gates)
    return record


class _ReadMeter:
    """What the fs plugin read, by the same wrapping as ``_TakeMeter``'s
    of its write: the metadata documents apart, payload bytes and reads."""

    def __init__(self):
        self._orig = fs_plugin.FSStoragePlugin.read
        self.reset()

    def reset(self):
        self.metadata_bytes = self.payload_bytes = self.payload_reads = 0

    def __enter__(self):
        meter, read = self, self._orig

        async def counting_read(plugin, io_req):
            await read(plugin, io_req)
            n = len(io_payload(io_req))
            if io_req.path == ".snapshot_metadata":
                meter.metadata_bytes += n
            else:
                meter.payload_bytes += n
                meter.payload_reads += 1

        fs_plugin.FSStoragePlugin.read = counting_read
        return self

    def __exit__(self, *exc):
        fs_plugin.FSStoragePlugin.read = self._orig


def _inspect_cli(*argv):
    """``python -m torchsnapshot_tpu_torch.inspect`` in a subprocess of
    this checkout: (exit code, stdout lines, seconds)."""
    begin = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torchsnapshot_tpu_torch.inspect", *argv],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    return proc.returncode, proc.stdout.splitlines(), time.perf_counter() - begin, proc.stderr[-2000:]


def phase_api(model, tokens, ceilings):
    """The rest of the Snapshot API at GPT-2 XL widths, full depth, f32
    (387 leaves, 6.23 GB), on the main path's model: a take with
    fingerprints; ``verify()`` of it (clean) beside the filesystem's read
    rate; ``copy_to`` a second directory with ``verify=True`` beside its
    write+fsync rate; an in-place change to layers 10 and 20 and an
    incremental take; ``diff`` of the two (exactly the changed leaves,
    and no payload byte read); a ``restore(paths=[layer 10],
    verify_device=True)`` into a fresh model on the card, reading exactly
    the selected leaves' bytes, K4 over each in one launch, and leaving every
    other leaf as it was; a ``paths=["**"]`` restore of the copy with a
    K1 forward bit-identical to the original model's; one byte flipped
    in the copy: ``verify()`` names that object alone, and ``copy_to``
    from it raises leaving no metadata at its destination; then the
    inspect CLI in a subprocess, ``--verify`` on the corrupt copy and
    ``--diff`` against it, gated on their exit codes."""
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    cfg = GPT2_XL
    params = model.params()
    leaves = list(tf.param_leaves(params))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_api-")
    free = shutil.disk_usage(workdir).free
    if free < 2.2 * state_bytes:
        shutil.rmtree(workdir)
        raise RuntimeError(f"{workdir} has {free} bytes free; the api phase needs {2.2 * state_bytes:.0f}")
    record = {"phase": "api", "model": "GPT-2 XL widths, f32", "leaves": len(leaves),
              "state_bytes": state_bytes, **ceilings}
    changed_layers = (10, 20)
    app = {"model": tf.TransformerState(model)}
    paths = {name: os.path.join(workdir, name) for name in ("full", "copy", "changed", "from_corrupt")}

    def flat_of(m):
        return flatten(tf.TransformerState(m).state_dict(), prefix="model")[1]

    def logits_of(m):
        with torch.no_grad():
            out = m(tokens)
        torch.cuda.synchronize()
        return out

    def timed(fn):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - begin

    changed_paths = sorted(p for p in flat_of(model)
                           if any(p.startswith(f"model/layers/{i}/") for i in changed_layers))
    selected_prefix = f"model/layers/{changed_layers[0]}/"
    try:
        _reset_launch_counts()  # the api path's counts start here
        with _ReadMeter() as reads:
            logits_before = logits_of(model)
            full, record["take_s"] = timed(lambda: Snapshot.take(paths["full"], app, fingerprint=True))

            reads.reset()
            problems, seconds = timed(lambda: Snapshot(paths["full"]).verify())
            record["verify"] = {"seconds": seconds, "problems": len(problems), "bytes_read": reads.payload_bytes,
                                "gbps": reads.payload_bytes / 1e9 / seconds, "fs_read_gbps": ceilings["fs_read_gbps"]}
            clean = problems == {}

            _, seconds = timed(lambda: Snapshot(paths["full"]).copy_to(paths["copy"], verify=True))
            record["copy_to"] = {"seconds": seconds, "gbps": state_bytes / 1e9 / seconds,
                                 "fs_write_fsync_gbps": ceilings["fs_write_fsync_gbps"]}

            with torch.no_grad():
                for i in changed_layers:
                    for t in tf.param_leaves(params["layers"][i]):
                        t.add_(1e-3)
            _, record["incremental_take_s"] = timed(lambda: Snapshot.take(paths["changed"], app, base=full))

            reads.reset()
            diff, seconds = timed(lambda: Snapshot(paths["changed"]).diff(paths["full"]))
            record["diff"] = {"seconds": seconds, "payload_bytes_read": reads.payload_bytes,
                              "metadata_bytes_read": reads.metadata_bytes,
                              **{k: len(v) for k, v in diff.items()}}

            fresh = tf.Transformer.init(cfg, seed=1)
            fresh_flat = flat_of(fresh)
            selected = sorted(p for p in fresh_flat if p.startswith(selected_prefix))
            ptrs = {p: t.data_ptr() for p, t in fresh_flat.items()}
            kept = {p: t.clone() for p, t in fresh_flat.items() if p not in selected}
            reads.reset()
            counts = _fp_counts()
            _, seconds = timed(lambda: Snapshot(paths["changed"]).restore(
                {"model": tf.TransformerState(fresh)}, paths=[selected_prefix + "**"], verify_device=True))
            model_flat = flat_of(model)
            after = flat_of(fresh)
            record["partial_restore"] = {
                "seconds": seconds, "selected_leaves": len(selected),
                "bytes_read": reads.payload_bytes, "reads": reads.payload_reads,
                "selected_bytes": sum(after[p].numel() * after[p].element_size() for p in selected),
                **_fp_delta(counts, "k4"),
                "verify_stats": dict(snapshot_mod._last_verify_stats),
                "selected_equal": all(torch.equal(after[p], model_flat[p]) for p in selected),
                "others_untouched": all(after[p].data_ptr() == ptrs[p] and torch.equal(after[p], t)
                                        for p, t in kept.items()),
            }
            del fresh, fresh_flat, after, kept

            fresh = tf.Transformer.init(cfg, seed=1)
            _, record["full_restore_of_copy_s"] = timed(lambda: Snapshot(paths["copy"]).restore(
                {"model": tf.TransformerState(fresh)}, paths=["**"]))
            record["copy_logits_bit_identical"] = bool(torch.equal(logits_of(fresh), logits_before))
            del fresh, logits_before

            # One byte of the object the copy reads first: a copy from it
            # fails at once, and (one object admitted at a time) writes nothing.
            victim = next(snapshot_mod._iter_payload_entries(Snapshot(paths["copy"]).get_manifest())).location
            victim_file = os.path.join(paths["copy"], victim)
            offset = os.path.getsize(victim_file) // 2
            with open(victim_file, "r+b") as f:
                f.seek(offset)
                byte = f.read(1)
                f.seek(offset)
                f.write(bytes([byte[0] ^ 0x01]))
            problems, seconds = timed(lambda: Snapshot(paths["copy"]).verify())
            record["verify_corrupt"] = {"seconds": seconds, "victim": victim, "named": sorted(problems)}
            os.environ["TPUSNAPSHOT_COPY_BUDGET_BYTES"] = "1"
            try:
                Snapshot(paths["copy"]).copy_to(paths["from_corrupt"], verify=True)
                record["corrupt_copy_raised"] = False
            except RuntimeError as e:
                record["corrupt_copy_raised"] = "Checksum mismatch" in str(e)
            finally:
                del os.environ["TPUSNAPSHOT_COPY_BUDGET_BYTES"]
            record["corrupt_copy_left_metadata"] = os.path.exists(
                os.path.join(paths["from_corrupt"], ".snapshot_metadata"))

        rc, out, seconds, err = _inspect_cli(paths["copy"], "--verify")
        record["cli_verify"] = {"rc": rc, "seconds": seconds, "lines": out[:4], "stderr": err if rc != 1 else ""}
        rc, out, seconds, err = _inspect_cli(paths["changed"], "--diff", paths["copy"])
        record["cli_diff"] = {"rc": rc, "seconds": seconds, "summary": out[-1:] if out else [],
                              "stderr": err if rc != 1 else ""}
        record["launches"] = {"flash_fwd": attention.flash_forward_launches,
                              "xs128_box": fops.fingerprint_box_launches,
                              "xs128_chunked": fops.fingerprint_chunked_launches}
        record["segments"] = {"xs128_box": fops.fingerprint_box_segments,
                              "xs128_chunked": fops.fingerprint_chunked_segments}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit(record)
    n = len(leaves)
    unchanged = sorted(set(flat_of(model)) - set(changed_paths))
    partial = record["partial_restore"]
    gates = {
        "verify of the take is clean": clean,
        "diff names exactly the changed leaves": diff["changed"] == changed_paths
        and diff["unchanged"] == unchanged and not (diff["added"] or diff["removed"] or diff["unknown"]),
        "diff reads no payload byte": record["diff"]["payload_bytes_read"] == 0,
        "partial restore reads exactly the selected leaves' bytes": partial["bytes_read"] == partial["selected_bytes"]
        and partial["selected_leaves"] == 8,
        "partial restore fingerprints every selected leaf with K4": partial["k4_segments"] == partial["selected_leaves"]
        and partial["verify_stats"] == {"verified": 8, "skipped": 0},
        "the partial verify_device restore launches K4 once": partial["k4_launches"] == 1,
        "partial restore lands the selected leaves": partial["selected_equal"],
        "partial restore leaves every other leaf as it was": partial["others_untouched"],
        "the copy restores to bit-identical K1 logits": record["copy_logits_bit_identical"],
        "verify names exactly the flipped object": record["verify_corrupt"]["named"] == [victim],
        "copy_to from the corrupt copy raises": record["corrupt_copy_raised"],
        "the failed copy leaves no metadata": not record["corrupt_copy_left_metadata"],
        "inspect --verify exits 1 naming the object": record["cli_verify"]["rc"] == 1
        and any(line.startswith(f"BAD {victim}:") for line in record["cli_verify"]["lines"]),
        "inspect --diff exits 1 with the changed leaves": record["cli_diff"]["rc"] == 1
        and record["cli_diff"]["summary"] == [
            f"0 added, 0 removed, {len(changed_paths)} changed, {n - len(changed_paths)} unchanged, 0 unknown"],
        "K1 and K4 ran on the path": record["launches"]["flash_fwd"] == 2 * cfg.n_layers
        and record["segments"]["xs128_box"] == 2 * n + 8,
        "the two fingerprinted takes and the partial restore launched K4 once each":
            record["launches"]["xs128_box"] == 3,
    }
    _hold("api", gates)
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


def _fp_counts():
    """K4 launches and segments, K5 launches and segments, and the K5
    dtype probes (the chunk store's proven dtypes), so far."""
    from torchsnapshot_tpu_torch import chunkstore
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    return (fops.fingerprint_box_launches, fops.fingerprint_box_segments, fops.fingerprint_chunked_launches,
            fops.fingerprint_chunked_segments, len(chunkstore._FP_AGREEMENT))


def _fp_delta(before, prefix=""):
    """What :func:`_fp_counts` gained since ``before``, by name (those
    starting with ``prefix``)."""
    names = ("k4_launches", "k4_segments", "k5_launches", "k5_segments", "k5_probes")
    return {k: a - b for k, a, b in zip(names, _fp_counts(), before) if k.startswith(prefix)}


def _reset_launch_counts():
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    attention.flash_forward_launches = 0
    attention.flash_bwd_dq_launches = 0
    attention.flash_bwd_dkv_launches = 0
    fops.fingerprint_box_launches = 0
    fops.fingerprint_chunked_launches = 0
    fops.fingerprint_box_segments = 0
    fops.fingerprint_chunked_segments = 0


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


def _spawn(fn, world, args, out_dir, kind, timeout_s=None):
    """Run ``fn`` on ``world`` spawned gloo ranks; (the records each rank
    wrote as ``<out_dir>/<kind>_<rank>.json``, the seconds it took)."""
    begin = time.perf_counter()
    run_multiprocess(fn, world, args, timeout_s=timeout_s or MODEL_RANK_TIMEOUT_S)
    return _mr_records(out_dir, kind, world), time.perf_counter() - begin


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
        saves, record["world2_s"] = _spawn(mr_save, 2, (base, out_dir), out_dir, "save", MR_RANK_TIMEOUT_S)
        record["world2"] = saves
        record["world2_save_gbps"] = sum(r["save_bytes"] for r in saves) / 1e9 / max(r["save_s"] for r in saves)
        record["world2_drain_gbps"] = (
            sum(r["async_bytes"] for r in saves) / 1e9 / max(r["async_drain_s"] for r in saves)
        )
        if saves[0]["all_steps"] != [2]:
            raise AssertionError(f"all_steps() is {saves[0]['all_steps']} after retention, expected [2]")
        if sum(r["local_bytes"] for r in saves) < state_bytes:
            raise AssertionError("the world-2 shards do not cover the state")

        restores, record["world4_s"] = _spawn(
            mr_restore, 4, (base, out_dir), out_dir, "restore", MR_RANK_TIMEOUT_S)
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
# (phase, config, ring_attention mode, chunk attentions a layer a rank).
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
    """The flagship at the phase's published widths and depth (SP_PHASES),
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

        ranks, record["spawned_world_s"] = _spawn(
            sp_rank, SP_WORLD, (phase, workdir), workdir, phase, SP_RANK_TIMEOUT_S)
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


# ---------------------------------------------------------------------------
# The other workloads and the reference-format interop: DLRM at the Criteo
# Kaggle widths (one process, then ep 2), the ResNet-18-width CNN, the
# synthetic DDP model and the dry run.

DLRM_BATCH = 128  # --mini-batch-size of bench/dlrm_s_criteo_kaggle.sh
DLRM_LR = 0.1  # its --learning-rate
DLRM_STEPS = 5
DLRM_BATCH_SEED = 100
DLRM_WORLD = 2
MODEL_RANK_TIMEOUT_S = 420.0
RESNET_BATCH = 128
RESNET_STEPS = 5
RESNET_BATCH_SEED = 200
# The dp-2 step against one process on the same global batch. The two
# sum the batch statistics and gradients in other orders, and cuDNN picks
# its algorithms by batch size, so the f32 weight gradients of layers
# followed by batch norm (which sum to zero over the batch, a cancelling
# sum) differ by tenths of a percent. Each parameter's step is therefore
# held to the same step in float64: within RESNET_DP_PARAM_REL of the
# leaf's largest float64 change, plus 2 ulp of its largest entry (the
# rounding of p − lr·g). The running statistics (no cancellation) are
# held to the one-process step within RESNET_DP_STATS_REL of the leaf's
# largest change. The loss within rtol 1e-4. tools/resnet_dp_faults.py
# reads both against the faults they are for, on an H100 80GB HBM3 at
# 700 W: sound, parameters 4.0e-3 (one process alone 3.9e-3) and
# statistics 2.5e-6; the gradient all-reduce left out, parameters 16.7;
# each rank's own statistics, parameters 0.23 and statistics 0.96. Each
# bound sits between its sound and its faulty reading.
RESNET_DP_PARAM_REL = 1e-2
RESNET_DP_STATS_REL = 1e-3
DDP_PARAMS = 20
DDP_PARAM_BYTES = 100 << 20  # the reference DDP benchmark's parameter size


def _state_bytes(*trees):
    return sum(tf._local(t).numel() * tf._local(t).element_size()
               for tree in trees for t in tf.param_leaves(tree))


def _trees_bit_equal(a, b):
    """How many leaves of two trees are byte-equal, and how many there are."""
    pairs = list(zip(tf.param_leaves(a), tf.param_leaves(b)))
    equal = sum(bool(x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))) for x, y in pairs)
    return equal, len(pairs)


# The DLRM chunk takes' expectations, from the chunk store's documented
# defaults rather than from its code: 4 MiB chunks (FP_CHUNK_BYTES) of
# each leaf's bytes, leaves under 64 KiB written whole, and leaves above
# the 512 MiB dense-chunk cap split into boxes, which are written whole.
CHUNK_MIN_BYTES = 64 << 10
DENSE_CHUNK_CAP_BYTES = 512 << 20


def _chunked(leaf):
    """Whether a chunk take chunks ``leaf``."""
    return CHUNK_MIN_BYTES <= leaf.numel() * leaf.element_size() <= DENSE_CHUNK_CAP_BYTES


def _chunks_of(leaf):
    return -(-leaf.numel() * leaf.element_size() // FP_CHUNK_BYTES)


def _changed_chunks(before, after):
    """4 MiB chunks of each leaf's bytes that differ between two values
    of it, compared on the card."""
    total = 0
    for a, b in zip(before, after):
        ne = a.reshape(-1).view(torch.uint8) != b.reshape(-1).view(torch.uint8)
        n = _chunks_of(a)
        full = (n - 1) * FP_CHUNK_BYTES
        total += int(ne[:full].view(n - 1, FP_CHUNK_BYTES).any(dim=1).sum()) + int(ne[full:].any())
    return total


def _dlrm_logits(params, batch):
    with torch.no_grad():
        out = dlrm.forward(params, *batch[:2], dlrm.CRITEO_KAGGLE)
    torch.cuda.synchronize()
    return out


def _fresh_dlrm(seed):
    """A DLRM state of other values than the seed-0 state: other tables
    and weights, momentum filled with -1."""
    params = dlrm.init_params(dlrm.CRITEO_KAGGLE, seed=seed)
    momentum = dlrm.init_momentum(params)
    for t in tf.param_leaves(momentum):
        t.fill_(-1.0)
    return dlrm.DLRMState(params, momentum)


def phase_dlrm(ceilings):
    """DLRM at the Criteo Kaggle widths of facebookresearch/dlrm's
    bench/dlrm_s_criteo_kaggle.sh (26 tables of torchrec's Kaggle row
    counts, 33,762,577 rows of 16 f32; bottom MLP 13-512-256-64-16, top
    367-512-256-1; batch 128, lr 0.1), one process, f32 with TF32 off and
    deterministic algorithms on: 5 momentum steps; a sync take with
    fingerprints of params, momentum and progress (4.33 GB), its s and
    GB/s against the write+fsync ceiling; a restore into a fresh model
    (bit-exact leaves, bit-identical logits; GB/s against the read
    ceiling); ``convert_back`` to the reference format and a
    ``ReferenceSnapshotReader.restore`` into a fresh model on the card
    (bit-exact; s and GB/s for both) and one ``read`` of the
    10,131,227-row table; two ``chunks=True`` takes around one more step,
    the second writing exactly the chunks whose bytes changed (compared
    on the card), K5 counted; a ``verify_device=True`` restore, K4
    counted."""
    from torchsnapshot_tpu_torch import chunkstore
    from torchsnapshot_tpu_torch.interop import ReferenceSnapshotReader
    from torchsnapshot_tpu_torch.interop.reference_writer import convert_back
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.cuda.empty_cache()
    cfg = dlrm.CRITEO_KAGGLE
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dlrm-")
    record = {"phase": "dlrm", "config": "dlrm_s_criteo_kaggle.sh widths, torchrec Kaggle rows, f32",
              "tables": len(cfg.table_rows), "rows": sum(cfg.table_rows.values()),
              "top_mlp_in": cfg.embed_dim + dlrm._n_pairs(cfg), "batch": DLRM_BATCH, "lr": DLRM_LR,
              "precision": "f32, TF32 off"}
    try:
        _reset_launch_counts()
        params = dlrm.init_params(cfg, seed=0)
        state = dlrm.DLRMState(params, dlrm.init_momentum(params))
        del params
        leaves = list(tf.param_leaves(state.params)) + list(tf.param_leaves(state.momentum))
        nbytes = _state_bytes(state.params, state.momentum)
        record["state_bytes"], record["leaves"] = nbytes, len(leaves)
        batches = [dlrm.synthetic_batch(cfg, DLRM_BATCH, seed=DLRM_BATCH_SEED + i)
                   for i in range(DLRM_STEPS + 1)]
        losses, step_s = [], []
        for batch in batches[:DLRM_STEPS]:
            torch.cuda.synchronize()
            begin = time.perf_counter()
            _, _, loss = dlrm.sgd_momentum_train_step(state.params, state.momentum, *batch, cfg, lr=DLRM_LR)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - begin)
        record["losses"], record["step_s"] = losses, step_s
        progress = StateDict(step=DLRM_STEPS)
        app = {"model": state, "progress": progress}
        probe = batches[0]
        logits = _dlrm_logits(state.params, probe)

        path = os.path.join(workdir, "run", "sync")
        torch.cuda.synchronize()
        begin = time.perf_counter()
        Snapshot.take(path, app, fingerprint=True)
        take_s = time.perf_counter() - begin
        record["take"] = {"seconds": take_s, "gbps": nbytes / 1e9 / take_s,
                          "fs_write_fsync_gbps": ceilings["fs_write_fsync_gbps"]}

        saved = _fresh_dlrm(1)
        begin = time.perf_counter()
        Snapshot(path).restore({"model": saved, "progress": StateDict(step=0)})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - begin
        record["restore"] = {"seconds": restore_s, "gbps": nbytes / 1e9 / restore_s,
                             "fs_read_gbps": ceilings["fs_read_gbps"],
                             "leaves_byte_equal": _trees_bit_equal(saved.state_dict(), state.state_dict()),
                             "logits_bit_identical": bool(torch.equal(_dlrm_logits(saved.params, probe), logits))}

        ref = os.path.join(workdir, "reference_format")
        begin = time.perf_counter()
        convert_back(path, ref)
        convert_s = time.perf_counter() - begin
        other = _fresh_dlrm(2)
        reader = ReferenceSnapshotReader(ref)
        progress_back = StateDict(step=0)
        begin = time.perf_counter()
        reader.restore({"model": other, "progress": progress_back})
        torch.cuda.synchronize()
        ref_restore_s = time.perf_counter() - begin
        begin = time.perf_counter()
        table = reader.read("model/params/tables/cat_2")
        read_s = time.perf_counter() - begin
        reader.close()
        record["reference_format"] = {
            "convert_back_s": convert_s, "convert_back_gbps": nbytes / 1e9 / convert_s,
            "reference_restore_s": ref_restore_s, "reference_restore_gbps": nbytes / 1e9 / ref_restore_s,
            "bytes_written": sum(os.path.getsize(p) for p in glob.glob(os.path.join(ref, "**"), recursive=True)
                                 if os.path.isfile(p)),
            "leaves_byte_equal": _trees_bit_equal(other.state_dict(), saved.state_dict()),
            "progress": progress_back["step"],
            "logits_bit_identical": bool(torch.equal(_dlrm_logits(other.params, probe), logits)),
            "read_table_rows": list(table.shape), "read_s": read_s,
            "read_table_byte_equal": bool(torch.equal(
                table.view(torch.int32), saved.params["tables"]["cat_2"].cpu().view(torch.int32))),
        }
        del other, table
        shutil.rmtree(ref)
        torch.cuda.empty_cache()

        # Chunk takes around one more step; the second writes the chunks
        # whose bytes the step changed. A leaf above the dense-chunk cap
        # (the 10,131,227-row table and its momentum) is split into boxes,
        # which take the plain path, as in the JAX package: written whole
        # by every take.
        chunkstore._FP_AGREEMENT.clear()
        eligible = [i for i, t in enumerate(leaves) if _chunked(t)]
        probes = len({leaves[i].dtype for i in eligible})
        with _TakeMeter() as meter:
            meter.take(record, "chunk_take_1", lambda: Snapshot.take(
                os.path.join(workdir, "run", "chunk-1"), app, chunks=True))
            before = [leaves[i].clone() for i in eligible]
            _, _, loss = dlrm.sgd_momentum_train_step(
                state.params, state.momentum, *batches[DLRM_STEPS], cfg, lr=DLRM_LR)
            progress["step"] = DLRM_STEPS + 1
            changed = _changed_chunks(before, [leaves[i] for i in eligible])
            del before
            torch.cuda.empty_cache()
            meter.take(record, "chunk_take_2", lambda: Snapshot.take(
                os.path.join(workdir, "run", "chunk-2"), app, chunks=True))
        record["chunk_take_2"]["changed_chunks"] = changed
        record["chunks_of_the_chunked_leaves"] = sum(_chunks_of(leaves[i]) for i in eligible)
        record["eligible_leaves"], record["k5_probes"] = len(eligible), probes
        record["leaves_over_the_cap"] = sum(
            t.numel() * t.element_size() > DENSE_CHUNK_CAP_BYTES for t in leaves)
        manifest = Snapshot(path).get_manifest()
        record["stored_array_objects"] = sum(
            len(e.shards) if isinstance(e, ShardedArrayEntry) else 1
            for e in manifest.values() if isinstance(e, (ArrayEntry, ShardedArrayEntry)))

        counts = _fp_counts()
        fresh = _fresh_dlrm(3)
        begin = time.perf_counter()
        Snapshot(path).restore({"model": fresh, "progress": StateDict(step=0)}, verify_device=True)
        torch.cuda.synchronize()
        record["verify_device_restore"] = {
            "seconds": time.perf_counter() - begin,
            **snapshot_mod._last_verify_stats,
            **_fp_delta(counts, "k4"),
            "leaves_byte_equal": _trees_bit_equal(fresh.state_dict(), saved.state_dict()),
        }
        record["launches"] = {"xs128_box": fops.fingerprint_box_launches,
                              "xs128_chunked": fops.fingerprint_chunked_launches}
        record["segments"] = {"xs128_box": fops.fingerprint_box_segments,
                              "xs128_chunked": fops.fingerprint_chunked_segments}

        # K4 and K5 at this path's shapes against their plain versions,
        # bit for bit (after the path's counts were read), each as one
        # batch: K4 on every leaf and on each stored box of the leaves
        # above the cap (what the verify_device restore hashed), K5 on
        # every leaf's 4 MiB grid.
        tree = state.state_dict()
        k4_cases = [(t, None) for t in leaves]
        for key, entry in manifest.items():
            if isinstance(entry, ShardedArrayEntry):
                leaf = tree
                for part in key.split("/")[2:]:  # "<rank>/model/params/tables/cat_2"
                    leaf = leaf[part]
                k4_cases += [(leaf, [(o, o + n) for o, n in zip(sh.offsets, sh.sizes)])
                             for sh in entry.shards]
        k4_err = max(_lanes_err(got, fops.fingerprint_box_reference(t, box))
                     for got, (t, box) in zip(fops.fingerprint_boxes(k4_cases), k4_cases))
        k5_err = max(_lanes_err(got, fops.fingerprint_chunked_reference(t, FP_CHUNK_BYTES))
                     for got, t in zip(fops.fingerprint_chunked_many(leaves, FP_CHUNK_BYTES), leaves))
        record["kernels_against_plain"] = {
            "k4_cases": len(k4_cases), "k4_boxes": len(k4_cases) - len(leaves), "k4_max_abs_err": k4_err,
            "k5_cases": len(leaves), "k5_max_abs_err": k5_err}
        del fresh, saved, state, leaves, tree
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    emit(record)
    n = record["leaves"]
    ref_fmt, verify = record["reference_format"], record["verify_device_restore"]
    gates = {
        "the state is 33,762,577 rows of 16, 4.33 GB": record["rows"] == 33762577
        and record["top_mlp_in"] == 367 and 4.3e9 < record["state_bytes"] < 4.4e9,
        "every loss is finite": all(math.isfinite(x) for x in record["losses"] + [float(loss)]),
        "restore is bit-exact": record["restore"]["leaves_byte_equal"] == (n, n)
        and record["restore"]["logits_bit_identical"],
        "the reference-format restore is bit-exact": ref_fmt["leaves_byte_equal"] == (n, n)
        and ref_fmt["logits_bit_identical"] and ref_fmt["progress"] == DLRM_STEPS,
        "the reference reader reads the largest table": ref_fmt["read_table_rows"] == [10131227, 16]
        and ref_fmt["read_table_byte_equal"],
        "chunk takes run K5 over every eligible leaf": [
            record[f"chunk_take_{s}"]["k5_segments"] for s in (1, 2)] == [len(eligible) + probes, len(eligible)],
        "each chunk take launches K5 once, beside the first take's dtype probes": [
            record[f"chunk_take_{s}"]["k5_launches"] for s in (1, 2)] == [1 + probes, 1],
        "the second chunk take writes exactly the changed chunks":
            record["chunk_take_2"]["chunk_objects_stored"] == changed,
        "verify_device checks every stored array with K4":
            (verify["verified"], verify["skipped"], verify["k4_segments"])
            == (record["stored_array_objects"], 0, record["stored_array_objects"])
            and verify["leaves_byte_equal"] == (n, n),
        "the verify_device restore launches K4 once": verify["k4_launches"] == 1,
        "K4 and K5 ran on the path": all(record["launches"].values()),
        "K4 and K5 agree with their plain versions on every leaf and box, bit for bit":
            record["kernels_against_plain"]["k4_max_abs_err"] == 0
            and record["kernels_against_plain"]["k5_max_abs_err"] == 0
            and record["kernels_against_plain"]["k4_boxes"] == sum(
                len(e.shards) for e in manifest.values() if isinstance(e, ShardedArrayEntry)) > 0,
    }
    _hold("dlrm", gates)
    return record


def _digests(tensors):
    """xs128 fingerprints of tensors on the card (K4), for comparing the
    bytes two processes hold."""
    from torchsnapshot_tpu_torch import fingerprint

    return fingerprint.resolve_fingerprints([fingerprint.fingerprint_device_async(t) for t in tensors])


def dlrm_ep_rank(rank, world, workdir, out_dir):
    """DLRM at the Criteo Kaggle widths with tables and momentum
    row-sharded over ``{"ep": world}``: one step on the phase's first
    batch, then a take with ``replicated=["**"]`` (each table box once,
    the MLPs once, striped); each local box's fingerprint for the
    parent's world-1 restore."""
    counts = _mr_count_payload_bytes()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    cfg = dlrm.CRITEO_KAGGLE
    mesh = make_mesh({"ep": world}, "cuda")
    full = dlrm.init_params(cfg, seed=0)
    params = dlrm.shard_params(full, mesh)
    momentum = dlrm.shard_params(dlrm.init_momentum(full), mesh)
    del full
    torch.cuda.empty_cache()
    batch = dlrm.synthetic_batch(cfg, DLRM_BATCH, seed=DLRM_BATCH_SEED)
    collectives.reset_counts()
    torch.cuda.synchronize()
    begin = time.perf_counter()
    _, _, loss = dlrm.sgd_momentum_train_step(params, momentum, *batch, cfg, mesh, lr=DLRM_LR)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - begin
    state = dlrm.DLRMState(params, momentum)
    begin = time.perf_counter()
    Snapshot.take(os.path.join(workdir, "ep"), {"model": state}, replicated=["**"])
    take_s = time.perf_counter() - begin
    locals_ = [t.to_local() for t in tf.param_leaves(state.state_dict())]
    boxes = [list(map(list, t_box)) for t_box in
             (io_preparer.dtensor_box(t) for t in tf.param_leaves(state.state_dict()))]
    tables = [t.to_local() for tree in (params, momentum) for t in tree["tables"].values()]
    record = {
        "rank": rank, "loss": float(loss), "step_s": step_s, "take_s": take_s,
        "bytes_written": counts["written"],
        "table_box_bytes": sum(t.numel() * t.element_size() for t in tables),
        "all_reduce_bytes": collectives.sent_bytes["all_reduce"],
        "staged_bytes": collectives.staged_bytes,
        "boxes": boxes, "digests": _digests(locals_),
        "uneven_tables": sorted(n for n, rows in cfg.table_rows.items() if rows % world),
        "peak_gb": _peak_gb(),
    }
    with open(os.path.join(out_dir, f"dlrm_ep_{rank}.json"), "w") as f:
        json.dump(record, f)


def phase_dlrm_ep(reference_loss):
    """The same configuration at ep 2: two processes sharing the card in
    one gloo group, the tables and momentum row-sharded (``torch.chunk``
    boxes: 583 rows as 292 + 291, and every other odd count), one step
    whose loss must be within rtol 1e-5 of the one-process loss on the
    same batch, a take (each rank's bytes: its table boxes, and half the
    replicated MLPs), and the world-1 restore into unsharded templates in
    this process, every box bit-equal to what the rank held."""
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dlrm_ep-")
    record = {"phase": "dlrm_ep", "mesh": {"ep": DLRM_WORLD}, "reference_loss": reference_loss,
              "loss_rtol": 1e-5}
    try:
        _reset_launch_counts()
        ranks, record["spawned_world_s"] = _spawn(dlrm_ep_rank, DLRM_WORLD, (workdir, workdir), workdir, "dlrm_ep")
        target = _fresh_dlrm(1)
        nbytes = _state_bytes(target.params, target.momentum)
        begin = time.perf_counter()
        Snapshot(os.path.join(workdir, "ep")).restore({"model": target})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - begin
        leaves = list(tf.param_leaves(target.state_dict()))
        equal = 0
        for r in ranks:
            mine = [t[tuple(slice(o, o + n) for o, n in zip(*box))] for t, box in zip(leaves, r["boxes"])]
            equal += sum(a == b for a, b in zip(_digests(mine), r["digests"]))
        del target, leaves
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    record.update(ranks=[{k: v for k, v in r.items() if k not in ("boxes", "digests")} for r in ranks],
                  state_bytes=nbytes, world1_restore_s=restore_s,
                  world1_restore_gbps=nbytes / 1e9 / restore_s,
                  boxes_bit_equal=equal, boxes=sum(len(r["boxes"]) for r in ranks))
    emit(record)
    written = sum(r["bytes_written"] for r in ranks)
    gates = {
        "the ranks' losses are equal": len({r["loss"] for r in ranks}) == 1,
        "the ep loss is within rtol 1e-5 of one process":
            abs(ranks[0]["loss"] - reference_loss) <= 1e-5 * abs(reference_loss),
        "every byte is written once": written == nbytes,
        "each rank writes its table boxes": all(r["bytes_written"] >= r["table_box_bytes"] for r in ranks),
        "the world-1 restore is bit-exact in every box": equal == record["boxes"],
    }
    _hold("dlrm_ep", gates)
    return record


def _resnet_app(params, stats):
    return {"params": PytreeStateful(params), "stats": PytreeStateful(stats)}


RESNET_DP_FAULTS = {
    # The gradient all-reduce left out: each rank steps on its own rows'
    # share of the gradient.
    "no_grad_sum": lambda: setattr(resnet, "all_reduce_", lambda t, group: t),
    # Batch statistics of each rank's rows alone (batch norm without
    # synchronisation): the local sums scaled by the world, over the
    # global count, are the local mean and variance.
    "rank_stats": lambda: setattr(
        resnet, "_summed",
        lambda x, group: x if group is None else x * torch.distributed.get_world_size(group)),
}


def resnet_rank(rank, world, snap, out_dir, fault=None):
    """One dp step of the ResNet-18-width CNN over ``{"dp": world}`` from
    the one-process snapshot ``snap``, on this rank's rows of the global
    batch (synchronised batch statistics, summed gradients), then a take
    with ``replicated=["**"]``. ``fault`` names one of
    ``RESNET_DP_FAULTS`` to inject into the step."""
    if fault is not None:
        RESNET_DP_FAULTS[fault]()
    counts = _mr_count_payload_bytes()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.RESNET18_CIFAR10
    mesh = make_mesh({"dp": world}, "cuda")
    params, stats = resnet.replicate_state(resnet.init_state(cfg, seed=1), mesh)
    app = _resnet_app(params, stats)
    Snapshot(snap).restore(app)
    params, stats = app["params"].tree, app["stats"].tree
    images, labels = resnet.synthetic_batch(cfg, RESNET_BATCH, seed=RESNET_BATCH_SEED + RESNET_STEPS)
    images, labels = resnet.dp_shard_batch(images, mesh), resnet.dp_shard_batch(labels, mesh)
    collectives.reset_counts()
    torch.cuda.synchronize()
    begin = time.perf_counter()
    params, stats, loss = resnet.sgd_train_step(params, stats, images, labels, cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - begin
    before = counts["written"]
    begin = time.perf_counter()
    Snapshot.take(os.path.join(out_dir, "dp"), _resnet_app(params, stats), replicated=["**"])
    record = {"rank": rank, "loss": float(loss), "step_s": step_s,
              "take_s": time.perf_counter() - begin, "bytes_written": counts["written"] - before,
              "all_reduce_bytes": collectives.sent_bytes["all_reduce"],
              "staged_bytes": collectives.staged_bytes, "local_rows": images.to_local().shape[0]}
    with open(os.path.join(out_dir, f"resnet_{rank}.json"), "w") as f:
        json.dump(record, f)


def _resnet_dp_step(snap, workdir, before, one, exact, fault=None):
    """Two processes sharing the card take one dp step from ``snap`` on
    the phase's last batch (``fault`` injected, if named) and take the
    result; that is restored here and held to the float64 step ``exact``
    (each parameter: the error beyond 2 ulp of its largest entry, over
    its largest float64 change) and each running statistic to the
    one-process step ``one`` (over its largest change)."""
    cfg = resnet.RESNET18_CIFAR10
    out_dir = os.path.join(workdir, fault or "sound")
    os.makedirs(out_dir)
    ranks, seconds = _spawn(resnet_rank, 2, (snap, out_dir, fault), out_dir, "resnet", MODEL_RANK_TIMEOUT_S)
    got = _resnet_app(*resnet.init_state(cfg, seed=2))
    Snapshot(os.path.join(out_dir, "dp")).restore(got)
    eps = torch.finfo(torch.float32).eps
    param_err, stats_err = {}, {}
    for i, (dp, want, old) in enumerate(zip(
            tf.param_leaves(got["params"].tree), tf.param_leaves(exact), tf.param_leaves(before["params"]))):
        change = float((want - old.double()).abs().max())
        slack = 2 * eps * float(want.abs().max())
        param_err[i] = max(float((dp.double() - want).abs().max()) - slack, 0.0) / (change or 1.0)
    for i, (dp, want, old) in enumerate(zip(
            tf.param_leaves(got["stats"].tree), tf.param_leaves(one["stats"]), tf.param_leaves(before["stats"]))):
        change = float((want - old).abs().max())
        stats_err[i] = float((dp - want).abs().max()) / (change or 1.0)
    return {"ranks": ranks, "spawned_world_s": seconds,
            "param_max_rel_err": max(param_err.values()),
            "param_worst_leaf": max(param_err, key=param_err.get),
            "stats_max_rel_err": max(stats_err.values())}


def phase_resnet(faults=()):
    """The JAX CNN at ResNet-18's widths (64, 128, 256, 512; 2 blocks a
    stage; no strides) on CIFAR-10's shapes (32×32×3, 10 classes), batch
    128, f32 with TF32 off: 5 SGD steps (the running statistics must
    change); a take with ``replicated=["**"]`` and a restore into a fresh
    model, bit-exact with the BN statistics; then two processes sharing
    the card take one dp step on the same global batch from that
    snapshot, each on its 64 rows, and take the result with
    ``replicated=["**"]`` (bytes a rank); each parameter's step agrees
    with the same step in float64 (and the one-process f32 step's error
    is printed beside it), each running statistic's with the one-process
    step, and the loss within rtol 1e-4 (bounds at
    ``RESNET_DP_PARAM_REL``). Each of ``faults`` (names of
    ``RESNET_DP_FAULTS``) then runs the dp step again with that fault
    injected: its readings are printed, and the gate it breaks must
    reject it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    cfg = resnet.RESNET18_CIFAR10
    workdir = tempfile.mkdtemp(prefix="chip_smoke_resnet-")
    record = {"phase": "resnet", "widths": list(cfg.widths), "blocks_per_stage": cfg.blocks_per_stage,
              "image": [cfg.image_size, cfg.image_size, cfg.in_channels], "batch": RESNET_BATCH,
              "precision": "f32, TF32 off (cuDNN and cuBLAS)",
              "dp_param_rel_bound": RESNET_DP_PARAM_REL, "dp_stats_rel_bound": RESNET_DP_STATS_REL}
    try:
        params, stats = resnet.init_state(cfg, seed=0)
        initial_stats = [t.clone() for t in tf.param_leaves(stats)]
        nbytes = _state_bytes(params, stats)
        record["state_bytes"] = nbytes
        losses, step_s = [], []
        for i in range(RESNET_STEPS + 1):
            images, labels = resnet.synthetic_batch(cfg, RESNET_BATCH, seed=RESNET_BATCH_SEED + i)
            if i == RESNET_STEPS:
                before = {"params": tf.map_leaves(torch.clone, params), "stats": tf.map_leaves(torch.clone, stats)}
                snap = os.path.join(workdir, "one")
                torch.cuda.synchronize()
                begin = time.perf_counter()
                Snapshot.take(snap, _resnet_app(params, stats), replicated=["**"])
                record["take_s"] = time.perf_counter() - begin
                fresh = _resnet_app(*resnet.init_state(cfg, seed=1))
                begin = time.perf_counter()
                Snapshot(snap).restore(fresh)
                torch.cuda.synchronize()
                record["restore_s"] = time.perf_counter() - begin
                record["restore_leaves_byte_equal"] = _trees_bit_equal(
                    {"p": fresh["params"].tree, "s": fresh["stats"].tree}, {"p": params, "s": stats})
                del fresh
            torch.cuda.synchronize()
            begin = time.perf_counter()
            params, stats, loss = resnet.sgd_train_step(params, stats, images, labels, cfg)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - begin)
            losses.append(float(loss))
        record["losses"], record["step_s"] = losses, step_s
        record["stats_changed"] = sum(
            not torch.equal(a, b) for a, b in zip(initial_stats, tf.param_leaves(stats)))
        record["stats_leaves"] = len(initial_stats)

        # The same step in float64 from the same state and batch.
        exact = tf.map_leaves(lambda t: t.double(), before["params"])
        s64 = tf.map_leaves(lambda t: t.double(), before["stats"])
        resnet.sgd_train_step(exact, s64, images.double(), labels, dataclasses.replace(cfg, dtype=torch.float64))
        eps = torch.finfo(torch.float32).eps
        record["one_process_param_max_rel_err"] = max(
            max(float((p.double() - want).abs().max()) - 2 * eps * float(want.abs().max()), 0.0)
            / (float((want - old.double()).abs().max()) or 1.0)
            for p, want, old in zip(tf.param_leaves(params), tf.param_leaves(exact),
                                    tf.param_leaves(before["params"])))
        one = {"stats": stats}
        dp = _resnet_dp_step(snap, workdir, before, one, exact)
        ranks = dp["ranks"]
        record.update(spawned_world_s=dp["spawned_world_s"], dp_param_max_rel_err=dp["param_max_rel_err"],
                      dp_param_worst_leaf=dp["param_worst_leaf"], dp_stats_max_rel_err=dp["stats_max_rel_err"])
        record["faults"] = {}
        for fault in faults:
            reading = _resnet_dp_step(snap, workdir, before, one, exact, fault)
            reading["losses"] = [r["loss"] for r in reading.pop("ranks")]
            record["faults"][fault] = reading
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    record["ranks"] = ranks
    emit(record)
    written = sum(r["bytes_written"] for r in ranks)
    gates = {
        "the running statistics changed": record["stats_changed"] == record["stats_leaves"],
        "the restore is bit-exact, BN statistics included":
            record["restore_leaves_byte_equal"][0] == record["restore_leaves_byte_equal"][1],
        "every loss is finite": all(math.isfinite(x) for x in losses),
        "the dp ranks' losses are equal": len({r["loss"] for r in ranks}) == 1,
        "the dp loss is within rtol 1e-4 of one process":
            abs(ranks[0]["loss"] - losses[-1]) <= 1e-4 * abs(losses[-1]),
        "the dp step's parameters agree with the float64 step":
            record["dp_param_max_rel_err"] <= RESNET_DP_PARAM_REL,
        "the dp step's running statistics agree with one process":
            record["dp_stats_max_rel_err"] <= RESNET_DP_STATS_REL,
        "the replicated take writes every byte once, on both ranks":
            written == nbytes and all(r["bytes_written"] > 0 for r in ranks),
    }
    faulty = record["faults"]
    if "no_grad_sum" in faulty:
        gates["the parameter gate rejects a lost gradient sum"] = (
            faulty["no_grad_sum"]["param_max_rel_err"] > RESNET_DP_PARAM_REL)
    if "rank_stats" in faulty:
        gates["the statistics gate rejects per-rank statistics"] = (
            faulty["rank_stats"]["stats_max_rel_err"] > RESNET_DP_STATS_REL)
    _hold("resnet", gates)
    return record


def ddp_rank(rank, world, path, out_dir):
    """The synthetic DDP model on the card, the same seed on every rank,
    taken with ``replicated=["**"]``: the writes striped over the ranks."""
    counts = _mr_count_payload_bytes()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    model = SyntheticModel(n_params=DDP_PARAMS, param_bytes=DDP_PARAM_BYTES, seed=0)
    torch.cuda.synchronize()
    begin = time.perf_counter()
    Snapshot.take(path, {"model": model}, replicated=["**"])
    record = {"rank": rank, "take_s": time.perf_counter() - begin, "bytes_written": counts["written"]}
    with open(os.path.join(out_dir, f"ddp_{rank}.json"), "w") as f:
        json.dump(record, f)


def phase_ddp():
    """The reference DDP benchmark's model (``SyntheticModel``) at its
    100 MiB parameter size, 20 of its 200 parameters (2.1 GB), on the
    card in two processes: a replicated take striped over the ranks (each
    writes about half), then a restore in this process into a model of
    other values, bit-exact."""
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ddp-")
    path = os.path.join(workdir, "ddp")
    record = {"phase": "ddp", "n_params": DDP_PARAMS, "param_bytes": DDP_PARAM_BYTES}
    try:
        ranks, record["spawned_world_s"] = _spawn(ddp_rank, 2, (path, workdir), workdir, "ddp")
        target = SyntheticModel(n_params=DDP_PARAMS, param_bytes=DDP_PARAM_BYTES, seed=1)
        nbytes = target.total_bytes()
        begin = time.perf_counter()
        Snapshot(path).restore({"model": target})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - begin
        expected = SyntheticModel(n_params=DDP_PARAMS, param_bytes=DDP_PARAM_BYTES, seed=0)
        equal = _trees_bit_equal(target.state_dict(), expected.state_dict())
        del target, expected
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    record.update(ranks=ranks, state_bytes=nbytes, restore_s=restore_s,
                  restore_gbps=nbytes / 1e9 / restore_s, leaves_byte_equal=equal,
                  take_gbps=nbytes / 1e9 / max(r["take_s"] for r in ranks))
    emit(record)
    gates = {
        "every byte is written once": sum(r["bytes_written"] for r in ranks) == nbytes,
        "each rank writes about half": all(
            abs(r["bytes_written"] - nbytes / 2) <= DDP_PARAM_BYTES for r in ranks),
        "the restore is bit-exact": equal == (DDP_PARAMS, DDP_PARAMS),
    }
    _hold("ddp", gates)
    return record


def phase_dryrun():
    """``dryrun.dryrun_multichip(2)`` on the card: two ranks sharing it
    run the JAX dry run's sequence (the zigzag ring step with flash chunks,
    so K1–K3 run as ring-chunk kernels; Ulysses; replicated, incremental
    with ``verify_device`` (K4), half-ranks and split restores; the DLRM
    ep step with its narrower-ep restore; the manager). Each rank's
    launches are read from its record."""
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dryrun-")
    try:
        begin = time.perf_counter()
        dryrun.dryrun_multichip(2, record_dir=workdir, timeout_s=MODEL_RANK_TIMEOUT_S)
        seconds = time.perf_counter() - begin
        ranks = _mr_records(workdir, "dryrun", 2)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record = {"phase": "dryrun", "world": 2, "seconds": seconds, "ranks": ranks}
    emit(record)
    gates = {
        "every loss is finite": all(math.isfinite(r[k]) for r in ranks for k in ("loss", "dlrm_loss")),
        "the ring ran flash chunks": all(r["ring_impl"] == "flash" for r in ranks),
        "K1-K3 ran on the ring": all(r["ring_launches"][k] > 0 for r in ranks
                                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
        "K4 ran on the fingerprinted takes": all(r["launches"]["xs128_box"] > 0 for r in ranks),
        "each fingerprinting take and restore launched K4 once on each rank's device": all(
            step["launches"] == (1 if step["segments"] else 0) for r in ranks for step in r["k4_by_step"].values())
        and all(r["k4_by_step"]["verify_device_restore"]["segments"] > 0 for r in ranks),
    }
    _hold("dryrun", gates)
    return record


# The faults phase (faultline at full width) and the examples phase.
FAULT_POINTS = 6  # crash points of the matrix: the first, the last, stride total//5 between
FAULT_RANK_DEADLINE_S = 20.0
FAULT_TRANSIENT_EVERY = 10
FAULT_TORN_KEEP_BYTES = 100


@contextlib.contextmanager
def _patched(owner, name, value):
    """Set ``owner.name`` for the block, then put it back."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, then put them back."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Lineage:
    """The values of the last two steps a manager saved of one model,
    changed in place between them: step s changes layer ``s % n_layers``
    by 1e-3, and the clones of that layer's old values give back the step
    before. Every probe compares a restore with one of the two."""

    def __init__(self, model):
        self.params = model.params()
        self.leaves = list(tf.param_leaves(self.params))
        self.live_step = 0
        self.prev = None  # (step, {leaf index: its old values})

    def advance(self, step):
        layer = self.params["layers"][step % len(self.params["layers"])]
        ids = {id(t) for t in tf.param_leaves(layer)}
        old = {i: t.clone() for i, t in enumerate(self.leaves) if id(t) in ids}
        with torch.no_grad():
            for i in old:
                self.leaves[i].add_(1e-3)
        self.prev = (self.live_step, old)
        self.live_step = step

    def expected(self, step):
        if step == self.live_step:
            return self.leaves
        if self.prev is not None and step == self.prev[0]:
            return [self.prev[1].get(i, t) for i, t in enumerate(self.leaves)]
        raise AssertionError(f"step {step} is neither the live step {self.live_step} nor the one before")


def faults_rank(rank, world, path, out_dir):
    """A world-2 take over a coordinator whose store mutes rank 1's
    publishes (``MuteRankStore``): the healthy rank's TimeoutError must
    name rank 1 within the coordinator's deadline."""
    from torch.distributed import distributed_c10d as c10d

    from torchsnapshot_tpu_torch import faultline as fl
    from torchsnapshot_tpu_torch.coord import StoreCoordinator, TorchStore

    torch.cuda.set_device(rank % torch.cuda.device_count())
    store = TorchStore(c10d._get_default_store(), prefix="chip_smoke_faults/")
    if rank == 1:
        store = fl.MuteRankStore(store, rank=1)
    coord = StoreCoordinator(store, rank, world, timeout_s=FAULT_RANK_DEADLINE_S)
    layer = tf.init_params(dataclasses.replace(GPT2_XL, n_layers=1), seed=rank)["layers"][0]
    begin = time.perf_counter()
    try:
        Snapshot.take(path, {"model": PytreeStateful(layer)}, coord=coord)
        outcome = "completed"
    except TimeoutError as e:
        outcome = f"TimeoutError: {e}"
    record = {"rank": rank, "outcome": outcome, "seconds": time.perf_counter() - begin,
              "state_bytes": sum(t.numel() * t.element_size() for t in tf.param_leaves(layer)),
              "dropped_publishes": len(getattr(store, "dropped", []))}
    with open(os.path.join(out_dir, f"faults_{rank}.json"), "w") as f:
        json.dump(record, f)


def phase_faults(model):
    """Crash consistency at GPT-2 XL widths, full depth, f32 (387 leaves,
    6.23 GB of CUDA tensors), on the fs backend, through the port's
    faultline: a ``CheckpointManager(max_to_keep=1, chunks=True)`` with
    both sweep age guards at 0, so each prune runs the chunk GC, K5
    fingerprints every 4 MiB chunk, and ``TPUSNAPSHOT_FINGERPRINT=1``
    records each leaf's K4 fingerprint for the probes' ``verify_device``. Each cycle changes one layer in place
    and saves the next step, pruning the one before.

    1. The crash matrix: the op boundaries of one fault-free cycle are
       counted; at ``FAULT_POINTS`` of them (the first, the last, stride
       total//5 between) a cycle crashes, then ``check_recovery_invariant``
       holds every marked and adopted step to ``verify()`` and to a
       ``verify_device`` restore into a CUDA template (K4) byte-equal to
       that step's values; then the re-drive (the next save,
       ``reconcile(adopt=True)``, ``assert_reclaimed``) leaves the clean
       base the next point starts from.
    2. A torn write of one small leaf, ``then="permanent"``: the save
       fails, the truncated object is on disk, ``verify`` refuses the
       uncommitted step, and ``reconcile`` reclaims it.
    3. Crashes at reads of a restore of the latest step: one inside the
       H2D pipeline's window (copies taken) before any leaf publishes,
       where the CUDA template keeps every byte; one halfway through the
       reads, where every leaf is wholly old or wholly new, and both kinds
       are there (leaf-atomic publish).
    4. A 503 on every 10th write of a whole (unchunked) take: it
       completes through the retry policy, restores byte-equal, and the
       faults show in ``fault_counts()``.
    5. A world-2 gloo take with rank 1's publishes muted: rank 0's
       ``TimeoutError`` names rank 1 within the deadline."""
    from torchsnapshot_tpu_torch import faultline as fl
    from torchsnapshot_tpu_torch.ops import fingerprint as fops

    cfg = GPT2_XL
    lineage = _Lineage(model)
    app = {"model": tf.TransformerState(model)}
    n = len(lineage.leaves)
    state_bytes = sum(t.numel() * t.element_size() for t in lineage.leaves)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_faults-")
    free = shutil.disk_usage(workdir).free
    if free < 2.5 * state_bytes:
        shutil.rmtree(workdir)
        raise RuntimeError(f"{workdir} has {free} bytes free; the faults phase needs {2.5 * state_bytes:.0f}")
    base = os.path.join(workdir, "run")
    probe_model = tf.Transformer.init(cfg, seed=1)
    probe_leaves = list(tf.param_leaves(probe_model.params()))
    probe_app = {"model": tf.TransformerState(probe_model)}
    record = {"phase": "faults", "model": "GPT-2 XL widths, f32", "leaves": n, "state_bytes": state_bytes,
              "backend": "fs", "manager": "CheckpointManager(max_to_keep=1, chunks=True)"}
    probes = {"restores": 0, "k4_launches": 0, "k4_segments": 0, "seconds": 0.0}

    def manager(**kwargs):
        return CheckpointManager(base, max_to_keep=1, chunks=True, **kwargs)

    def probe(step):
        """Restore ``step`` into the template with ``verify_device`` and
        hold every leaf to that step's bytes."""
        begin = time.perf_counter()
        with torch.no_grad():
            for t in probe_leaves:
                t.fill_(0.5)
        counts = _fp_counts()
        Snapshot(os.path.join(base, f"step-{step}")).restore(probe_app, verify_device=True)
        torch.cuda.synchronize()
        want = lineage.expected(step)
        bad = [i for i, (got, exp) in enumerate(zip(probe_leaves, want)) if not torch.equal(got, exp)]
        assert not bad, f"step {step}: {len(bad)} leaves differ from the step's values"
        assert snapshot_mod._last_verify_stats == {"verified": n, "skipped": 0}, snapshot_mod._last_verify_stats
        probes["restores"] += 1
        for k, v in _fp_delta(counts, "k4").items():
            probes[k] += v
        probes["seconds"] += time.perf_counter() - begin

    def redrive(step):
        """The recovery after a fault: the next save and its prune, a
        reconcile, and nothing left but the new step's objects."""
        lineage.advance(step)
        mgr = manager(reconcile_on_init="adopt")
        mgr.save(step, app)
        mgr.reconcile(adopt=True)
        assert mgr.latest_step() == step, (mgr.latest_step(), step)
        fl.assert_reclaimed(base, [step])

    phase_begin = time.perf_counter()
    try:
        with _env(TPUSNAPSHOT_SWEEP_MIN_AGE_S=0, TPUSNAPSHOT_REFS_MIN_AGE_S=0,
                  TPUSNAPSHOT_STORAGE_RETRY_CAP_S=0.01, TPUSNAPSHOT_FINGERPRINT=1):
            torch.cuda.synchronize()
            _reset_launch_counts()
            begin, counts = time.perf_counter(), _fp_counts()
            manager().save(0, app)
            record["first_save_s"] = time.perf_counter() - begin
            record["first_save_fingerprints"] = _fp_delta(counts)
            step = 1
            lineage.advance(step)
            begin, counts = time.perf_counter(), _fp_counts()
            total = fl.count_storage_ops(lambda: manager().save(step, app))
            record["cycle"] = {"ops": total, "seconds": time.perf_counter() - begin,
                               "fingerprints": _fp_delta(counts)}
            stride = max(1, total // 5)
            points = sorted(set(range(1, total + 1, stride)) | {1, total})
            if len(points) > FAULT_POINTS:
                points = points[:FAULT_POINTS - 1] + [total]
            outcomes = []
            for k in points:
                begin = time.perf_counter()
                step += 1
                lineage.advance(step)
                with fl.inject(fl.FaultSchedule().crash_at(k)) as ctl:
                    try:
                        manager().save(step, app)
                        crashed = False
                    except fl.SimulatedCrash:
                        crashed = True
                at = next((r for r in ctl.records if r.kind == "crash"), None)
                inv = fl.check_recovery_invariant(base, probe)
                checked = time.perf_counter() - begin
                step += 1
                redrive(step)
                outcomes.append({
                    "op_index": k, "crashed": crashed, "boundary": f"{at.op}({at.path})" if at else None,
                    "marked_steps": inv.marked_steps, "adopted_steps": inv.adopted_steps,
                    "saved_step": step - 1, "check_s": checked, "seconds": time.perf_counter() - begin,
                })
                print(f"faults: crash at op {k}/{total} {outcomes[-1]['boundary']}: marked "
                      f"{inv.marked_steps}, adopted {inv.adopted_steps}, {outcomes[-1]['seconds']:.1f} s",
                      flush=True)
            probe(step)
            record["crash_matrix"] = outcomes

            # A torn write of one small leaf (plain, not chunked) in a save.
            step += 1
            lineage.advance(step)
            torn_path = "0/model/layers/7/ln1"
            sched = fl.FaultSchedule().torn_write(path=torn_path, keep_bytes=FAULT_TORN_KEEP_BYTES,
                                                  then="permanent", times=None)
            with fl.inject(sched) as ctl:
                try:
                    manager().save(step, app)
                    torn_raised = False
                except fl.InjectedPermanentError:
                    torn_raised = True
            torn_file = os.path.join(base, f"step-{step}", torn_path)
            torn_size = os.path.getsize(torn_file) if os.path.exists(torn_file) else None
            try:
                Snapshot(os.path.join(base, f"step-{step}")).verify()
                verify_refused = False
            except FileNotFoundError:
                verify_refused = True
            marked_after_torn = CheckpointManager(base).all_steps()
            reclaimed = CheckpointManager(base).reconcile(adopt=True)
            fl.assert_reclaimed(base, marked_after_torn)
            probe(marked_after_torn[-1])
            record["torn_write"] = {
                "step": step, "path": torn_path, "raised": torn_raised, "faults": ctl.fault_counts(),
                "size_on_disk": torn_size, "verify_refused": verify_refused,
                "marked_steps": marked_after_torn, "reconcile_handled": reclaimed,
            }
            step += 1
            redrive(step)

            # Crashes at reads of a restore of the latest step. A restore
            # without faults first counts its content-chunk reads, and
            # the reads it had made when the H2D pipeline took its first
            # copy and when the first leaf published. The first crash is
            # halfway between the two: copies have been taken and nothing
            # is published, so the template keeps every byte. The second
            # is halfway through the reads, where some leaves have
            # published and others have not: each must be wholly old or
            # wholly new.
            snap_path = os.path.join(base, f"step-{step}")
            want = lineage.expected(step)
            submit, publish = transfer.H2DPipeline.submit, io_preparer.ArrayRestorePlan._publish
            seen = {"submits": 0}

            def noting_submit(self, *args, **kwargs):
                seen["submits"] += 1
                seen.setdefault("reads_at_first_submit", seen["reads"]())
                return submit(self, *args, **kwargs)

            def noting_publish(self):
                seen.setdefault("reads_at_first_publish", seen["reads"]())
                return publish(self)

            counted = fl.FaultSchedule().latency(op="read", path="objects/*", seconds=0.0)
            with fl.inject(counted) as ctl, _patched(transfer.H2DPipeline, "submit", noting_submit), \
                    _patched(io_preparer.ArrayRestorePlan, "_publish", noting_publish):
                seen["reads"] = lambda: len(ctl.records)
                Snapshot(snap_path).restore(probe_app)
            torch.cuda.synchronize()
            chunk_reads = ctl.fault_counts().get("latency", 0)
            counted_equal = all(torch.equal(t, w) for t, w in zip(probe_leaves, want))

            def read_crash(nth):
                """Restore with a crash at the nth content-chunk read; the
                copies the H2D pipeline had taken when it struck, and what
                it left in the template."""
                with torch.no_grad():
                    for t in probe_leaves:
                        t.fill_(0.5)
                torch.cuda.synchronize()
                seen.update(submits=0, reads=lambda: 0)
                at_crash = {}
                sched = fl.FaultSchedule().crash_on(op="read", path="objects/*", nth=nth)
                with fl.inject(sched) as ctl, _patched(transfer.H2DPipeline, "submit", noting_submit):
                    on_op = ctl.on_op

                    def noting_on_op(op, path):
                        try:
                            return on_op(op, path)
                        except fl.SimulatedCrash:
                            at_crash.setdefault("h2d_submitted", seen["submits"])
                            raise

                    ctl.on_op = noting_on_op
                    try:
                        Snapshot(snap_path).restore(probe_app)
                        crashed = False
                    except fl.SimulatedCrash:
                        crashed = True
                torch.cuda.synchronize()
                old = sum(bool((t == 0.5).all()) for t in probe_leaves)
                new = sum(torch.equal(t, w) for t, w in zip(probe_leaves, want))
                return {"nth_read": nth, "crashed": crashed, "ops_before_crash": ctl.op_index,
                        "h2d_submitted_before_crash": at_crash.get("h2d_submitted"),
                        "h2d_submitted": seen["submits"], "leaves_old": old, "leaves_new": new}

            window = (seen.get("reads_at_first_submit"), seen.get("reads_at_first_publish"))
            record["read_crash"] = {
                "chunk_reads": chunk_reads, "h2d_depth": transfer.h2d_depth(),
                "reads_at_first_submit": window[0], "reads_at_first_publish": window[1],
                "fault_free_byte_equal": counted_equal,
            }
            if None not in window and window[1] - window[0] >= 2:
                record["read_crash"]["in_h2d_window"] = read_crash(sum(window) // 2)
            record["read_crash"]["halfway"] = read_crash(chunk_reads // 2)
            for name, point in record["read_crash"].items():
                if isinstance(point, dict):
                    print(f"faults: read crash {name} at read {point['nth_read']}/{chunk_reads}: "
                          f"{point['h2d_submitted_before_crash']} H2D copies taken, leaves old "
                          f"{point['leaves_old']}, new {point['leaves_new']} of {n}", flush=True)
            record["launches"] = {"xs128_box": fops.fingerprint_box_launches,
                                  "xs128_chunked": fops.fingerprint_chunked_launches}
            record["segments"] = {"xs128_box": fops.fingerprint_box_segments,
                                  "xs128_chunked": fops.fingerprint_chunked_segments}
            record["probes"] = dict(probes)
        shutil.rmtree(base, ignore_errors=True)

        # A 503 on about every 10th write of a whole take, through the
        # retry policy: one rule each for the 10th, 20th, ... write attempt
        # it sees (a rule sees no attempt an earlier rule failed). The
        # zero-second latency rule first counts every attempt.
        sched = fl.FaultSchedule().latency(op="write", seconds=0.0)
        for k in range(FAULT_TRANSIENT_EVERY, 10 * n, FAULT_TRANSIENT_EVERY):
            sched.transient(op="write", nth=k, times=1)
        path = os.path.join(workdir, "transient")
        with _env(TPUSNAPSHOT_STORAGE_RETRY_CAP_S=0.01), fl.inject(sched) as ctl:
            begin = time.perf_counter()
            Snapshot.take(path, app)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - begin
        objects = sum(len(files) for _, _, files in os.walk(path))
        with torch.no_grad():
            for t in probe_leaves:
                t.fill_(0.5)
        Snapshot(path).restore(probe_app)
        torch.cuda.synchronize()
        record["transient"] = {
            "seconds": seconds, "gbps": state_bytes / seconds / 1e9, "faults": ctl.fault_counts(),
            "objects": objects, "write_attempts": ctl.fault_counts().get("latency", 0),
            "byte_equal": all(torch.equal(a, b) for a, b in zip(probe_leaves, lineage.leaves)),
        }
        shutil.rmtree(path, ignore_errors=True)
        del probe_model, probe_leaves, probe_app
        torch.cuda.empty_cache()

        # Rank faults: world 2 sharing the card, rank 1 muted.
        out_dir = os.path.join(workdir, "ranks")
        os.makedirs(out_dir)
        ranks, seconds = _spawn(faults_rank, 2, (os.path.join(workdir, "muted"), out_dir), out_dir,
                                "faults", timeout_s=MODEL_RANK_TIMEOUT_S)
        record["rank_fault"] = {"deadline_s": FAULT_RANK_DEADLINE_S, "ranks": ranks, "seconds": seconds}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record["seconds"] = time.perf_counter() - phase_begin
    emit(record)
    torn, crash, transient, rank0 = (record["torn_write"], record["read_crash"], record["transient"],
                                      record["rank_fault"]["ranks"][0])
    window, halfway = crash.get("in_h2d_window", {}), crash["halfway"]
    gates = {
        "the matrix crashed at every point": all(o["crashed"] for o in record["crash_matrix"])
        and len(record["crash_matrix"]) >= 4,
        "the matrix spans the commit": any(o["saved_step"] in o["marked_steps"] for o in record["crash_matrix"])
        and any(o["saved_step"] not in o["marked_steps"] + o["adopted_steps"] for o in record["crash_matrix"]),
        "every probe verified every leaf with K4": probes["k4_segments"] == n * probes["restores"],
        "each probe's verify_device restore launched K4 once": probes["k4_launches"] == probes["restores"],
        "the first and the counted save each launched K4 and K5 once": all(
            (c["k4_launches"], c["k4_segments"], c["k5_launches"] - c["k5_probes"]) == (1, n, 1)
            for c in (record["first_save_fingerprints"], record["cycle"]["fingerprints"])),
        "the torn save failed": torn["raised"] and torn["faults"].get("torn", 0) >= 1,
        "the torn object landed truncated": torn["size_on_disk"] == FAULT_TORN_KEEP_BYTES,
        "verify refuses the uncommitted step": torn["verify_refused"],
        "the torn step is invisible and reclaimed": torn["step"] not in torn["marked_steps"]
        and torn["step"] in torn["reconcile_handled"],
        "a restore without faults is byte-equal": crash["fault_free_byte_equal"],
        "the fault-free restore took H2D copies before its first publish": bool(window),
        "both read crashes surfaced": window.get("crashed") and halfway["crashed"],
        "the first read crash struck with H2D copies taken": (window.get("h2d_submitted_before_crash") or 0) >= 1,
        "the CUDA template is untouched after the first read crash": window.get("leaves_old") == n,
        "each leaf is wholly old or wholly new after the halfway read crash":
            halfway["leaves_old"] + halfway["leaves_new"] == n,
        "the halfway read crash left old and new leaves": halfway["leaves_old"] >= 1 and halfway["leaves_new"] >= 1,
        "the transient take completed byte-equal": transient["byte_equal"],
        "each injected 503 cost one retried attempt": transient["faults"].get("transient", 0) > 0
        and transient["write_attempts"] == transient["objects"] + transient["faults"]["transient"],
        "rank 0 names the muted rank within the deadline": "rank 1" in rank0["outcome"]
        and rank0["outcome"].startswith("TimeoutError") and rank0["seconds"] <= FAULT_RANK_DEADLINE_S + 15,
        "rank 1's publishes were dropped": record["rank_fault"]["ranks"][1]["dropped_publishes"] > 0,
        "K4 and K5 ran on the path": all(record["launches"].values()),
    }
    _hold("faults", gates)
    return record


# The example scripts, each with the lines it must print: its
# ``expected_lines`` (what its JAX counterpart in examples/ prints), which
# the CPU tests read too.
EXAMPLES = ("simple_example", "checkpoint_manager_example", "async_checkpoint_example",
            "incremental_example", "embedding_example", "long_context_example")


def _example_lines(name):
    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.expected_lines("cuda")


EXAMPLE_TIMEOUT_S = 600


def phase_examples():
    """The six scripts of ``examples_torch/`` on the card, each a
    subprocess as a user runs it (cwd the checkout, its own work
    directory), three at a time, the two that spawn worlds first (each
    world meets on a free port), then async_checkpoint_example alone, so
    that the stall it measures shares the card with no other script:
    each must exit 0 and print its lines.
    The incremental example's K4 launches and leaves and the long-context
    example's K1, K2 and K3 launches are read from what they print."""
    from concurrent.futures import ThreadPoolExecutor

    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_examples-")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(name):
        lines = _example_lines(name)
        cmd = [sys.executable, os.path.join(ROOT, "examples_torch", f"{name}.py"),
               "--work-dir", os.path.join(workdir, name)]
        begin = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S,
                              env=env, cwd=ROOT)
        out = proc.stdout
        run = {"rc": proc.returncode, "seconds": time.perf_counter() - begin,
               "missing_lines": [line for line in lines if line not in out],
               "last_lines": out.strip().splitlines()[-3:]}
        if proc.returncode != 0:
            run["stderr_tail"] = proc.stderr[-3000:]
        for line in out.splitlines():
            if "K4 launch" in line:
                # "step N: ..., B bytes, L K4 launch(es) over S leaves"
                launched, leaves = line.rsplit(" bytes, ", 1)[1].split(" K4 launch(es) over ")
                run.setdefault("k4_launches_a_save", []).append(int(launched))
                run.setdefault("k4_segments_a_save", []).append(int(leaves.split()[0]))
                run["k4_launches"] = sum(run["k4_launches_a_save"])
            for k in ("K1", "K2", "K3"):
                if f"{k} launches " in line:
                    run[f"{k.lower()}_launches"] = int(line.split(f"{k} launches ", 1)[1].split(",")[0].rstrip(")"))
        print(f"examples: {name} rc {proc.returncode} in {run['seconds']:.1f} s", flush=True)
        return run

    alone = "async_checkpoint_example"
    order = ["embedding_example", "long_context_example"]
    order += [name for name in EXAMPLES if name not in order and name != alone]
    try:
        with ThreadPoolExecutor(3) as pool:
            done = dict(zip(order, pool.map(run, order)))
        done[alone] = run(alone)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    runs = {name: done[name] for name in EXAMPLES}
    record = {"phase": "examples", "runs": runs,
              "launches": {"flash_fwd": runs["long_context_example"].get("k1_launches", 0),
                           "flash_bwd_dq": runs["long_context_example"].get("k2_launches", 0),
                           "flash_bwd_dkv": runs["long_context_example"].get("k3_launches", 0),
                           "xs128_box": runs["incremental_example"].get("k4_launches", 0)}}
    emit(record)
    gates = {f"{name} exits 0 with its lines": r["rc"] == 0 and not r["missing_lines"] for name, r in runs.items()}
    gates["K1, K2, K3 and K4 ran on the path"] = all(record["launches"].values())
    inc = runs["incremental_example"]
    gates["each incremental_example save launched K4 once over its 3 leaves"] = (
        inc.get("k4_launches_a_save") == [1] * 4 and inc.get("k4_segments_a_save") == [3] * 4)
    _hold("examples", gates)
    return record


def _gpt2_xl_shapes(cfg):
    d, f = cfg.d_model, cfg.d_ff
    layer = [(d, d)] * 4 + [(d, f), (f, d), (d,), (d,)]
    return [(cfg.vocab_size, d), (cfg.max_seq_len, d), (d,)] + layer * cfg.n_layers


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available.", file=sys.stderr)
        return 2
    seconds = {}

    def timed_phase(name, fn, *args):
        begin = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - begin
        return result

    smi, device = timed_phase("device", phase_device)
    timed_phase("build", phase_build)
    flash = timed_phase("kernel", phase_kernel)
    flash_bwd = timed_phase("kernel_bwd", phase_kernel_bwd)
    transfer_record = timed_phase("transfer", phase_transfer)
    fingerprint = timed_phase("kernel_fingerprint", phase_kernel_fingerprint)
    main_path, model, tokens = timed_phase("main_path", phase_main_path, transfer_record["h2d_pinned_gbps"])
    dedup = timed_phase("dedup", phase_dedup, model, tokens)
    ceilings = {k: main_path[k] for k in ("fs_read_gbps", "fs_write_fsync_gbps")}
    api = timed_phase("api", phase_api, model, tokens, ceilings)
    faults = timed_phase("faults", phase_faults, model)
    del model, tokens
    torch.cuda.empty_cache()
    timed_phase("torn_leaf", phase_torn_leaf)
    train = timed_phase("train", phase_train)
    multi_rank = timed_phase("multi_rank", phase_multi_rank)
    sp_paths = {phase: timed_phase(phase, phase_seq_parallel, phase) for phase in SP_PHASES}
    dlrm_record = timed_phase("dlrm", phase_dlrm, ceilings)
    timed_phase("dlrm_ep", phase_dlrm_ep, dlrm_record["losses"][0])
    timed_phase("resnet", phase_resnet)
    timed_phase("ddp", phase_ddp)
    dryrun_ranks = timed_phase("dryrun", phase_dryrun)["ranks"]
    examples = timed_phase("examples", phase_examples)
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
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
        "launches_api_path": api["launches"]["flash_fwd"],
        "launches_multi_rank_path": multi_rank["flash_launches"],
        **sp_launches(0),
        "launches_dryrun_path": dryrun_ranks[0]["ring_launches"]["flash_fwd"],
        "launches_examples_path": examples["launches"]["flash_fwd"],
        "ring_chunk": chunk_row(flash["ring_chunk_causal"], "kernel_ms", "bound_ms"),
        "dryrun_chunk": chunk_row(flash["dryrun_chunk_causal"], "kernel_ms", "bound_ms"),
        "examples_chunk": chunk_row(flash["examples_chunk_causal"], "kernel_ms", "bound_ms"),
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
            "launches_dryrun_path": dryrun_ranks[0]["ring_launches"][name],
            "launches_examples_path": examples["launches"][name],
            "ring_chunk": chunk_row(flash_bwd["ring_chunk_causal"], f"{key}_kernel_ms", f"{key}_bound_ms"),
            "dryrun_chunk": chunk_row(flash_bwd["dryrun_chunk_causal"], f"{key}_kernel_ms", f"{key}_bound_ms"),
            "examples_chunk": chunk_row(flash_bwd["examples_chunk_causal"], f"{key}_kernel_ms",
                                        f"{key}_bound_ms"),
            "ring_chunk_dlse_max_abs_err": flash_bwd["ring_chunk_dlse"]["max_abs_err"],
            "examples_chunk_dlse_max_abs_err": max(flash_bwd[c]["max_abs_err"] for c in (
                "examples_chunk_dlse", "examples_chunk_causal_dlse")),
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
        timings = fingerprint["timings"]
        state = timings["state"]

        def fp_row(row):
            return {"ms": row[f"{key}_ms"], "call_ms": row[f"{key}_call_ms"], "plain_ms": row[f"{key}_plain_ms"],
                    "bound_ms": row[f"{key}_bound_ms"], "bound_by": row[f"{key}_bound_by"],
                    "bytes_bound_ms": row["bytes_bound_ms"], "integer_bound_ms": row[f"{key}_integer_bound_ms"],
                    "int32_sum_ms": row["int32_sum_ms"]}

        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "torchsnapshot_tpu_torch/csrc/fingerprint.cu",
            "replaces": f"torchsnapshot_tpu/fingerprint.py:{line}",
            # Launches (one a batch on a device) and the leaves or boxes
            # fingerprinted, by path.
            "launches": dedup["launches"][name],
            "segments": dedup["segments"][name],
            "launches_api_path": api["launches"][name],
            "segments_api_path": api["segments"][name],
            "launches_dlrm_path": dlrm_record["launches"][name],
            "segments_dlrm_path": dlrm_record["segments"][name],
            "dlrm_max_abs_err": dlrm_record["kernels_against_plain"][f"{key}_max_abs_err"],
            "launches_dryrun_path": dryrun_ranks[0]["launches"][name],
            "segments_dryrun_path": sum(s["segments"] for s in dryrun_ranks[0]["k4_by_step"].values())
            if key == "k4" else 0,
            "launches_faults_path": faults["launches"][name],
            "segments_faults_path": faults["segments"][name],
            **({"launches_examples_path": examples["launches"][name],
                "segments_examples_path": sum(examples["runs"]["incremental_example"]["k4_segments_a_save"])}
               if name in examples["launches"] else {}),
            "max_abs_err": fingerprint["max_abs_err"],
            # One batch of the 387 state leaves (the prepared launch; the
            # wrapper's call from a list of tensors as call_ms); w1 and the
            # embed alone beside it.
            **fp_row(state),
            "library_ms": None,
            "hbm_reference_int32_sum_ms": state["int32_sum_ms"],
            "plan": state[f"{key}_plan"],
            "w1": fp_row(timings["w1"]),
            "embed": fp_row(timings["embed"]),
            "sass": {k: {p: fingerprint["sass"][k][p] for p in ("fma_pipe", "alu_pipe")}
                     for k in FP_PATHS} if fingerprint["sass"] else None,
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
