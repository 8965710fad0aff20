"""Long-context training slice: ring attention over a sequence-sharded
world, with checkpoint/resume of the sp-sharded state.

The port of ``examples/long_context_example.py``:

1. ``ring_attention`` computes exact causal attention with Q/K/V sharded
   over the ``sp`` ranks — no rank ever holds the S×S score matrix or the
   full sequence's scores — checked against the einsum reference
   attention.
2. The zigzag ring with flash chunks (on a card the CUDA kernels K1–K3)
   balances causal work, and is differentiable end to end.
3. ``Snapshot.take``/``restore`` checkpoint the sequence-sharded
   tensors like any sharded DTensor, including an elastic restore onto a
   world half as wide. Beside the snapshot, ``taken_state/`` keeps a host
   copy of the (gathered) state the take saw.

Where the JAX script runs one program over every local device, this one
spawns a gloo world of ``--world`` ranks (4 by default, 2 on a card,
whose ranks share it) and then a world of half as many for the restore.

Run:  PYTHONPATH=. python examples_torch/long_context_example.py [--work-dir DIR] [--device cpu]
"""

import argparse
import os
import tempfile
from typing import List

import torch
import torch.distributed as dist

from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch.ops import attention as attn_ops
from torchsnapshot_tpu_torch.parallel.mesh import make_mesh, shard_pytree
from torchsnapshot_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_zigzag,
    seq_slice,
    to_zigzag,
)
from torchsnapshot_tpu_torch.parallel.ulysses import _reference_attention
from torchsnapshot_tpu_torch.utils.test_utils import record_taken_state, run_multiprocess

B, H, D = 1, 4, 32
TOKENS_PER_RANK = 512
# The flash chunks' f32 products are 3xTF32 on a card (float tolerance,
# not bitwise: ROADMAP "Known differences").
FLASH_TOL = 1e-4


def default_world(device: str) -> int:
    return 2 if device.startswith("cuda") else 4


def expected_lines(device: str) -> List[str]:
    """The lines this script prints, as its JAX counterpart in ``examples/``
    prints them (on ``device``)."""
    n = default_world(device)
    tokens = TOKENS_PER_RANK * n
    return [
        f"{n}-way sequence parallelism, {tokens} tokens",
        "ring == dense reference",
        f"zigzag+flash ring gradients computed for {tokens} tokens",
        f"OK: sp-sharded state round-tripped onto a {max(1, n // 2)}-way mesh",
    ]


def _qkv(n: int, device: torch.device):
    s = TOKENS_PER_RANK * n  # the sequence scales with the world
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, H, s, D, generator=g).to(device) for _ in range(3)]


def _device(device_type: str, rank: int) -> torch.device:
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _launches():
    """This process's launches of K1, K2 and K3 so far."""
    return (attn_ops.flash_forward_launches, attn_ops.flash_bwd_dq_launches,
            attn_ops.flash_bwd_dkv_launches)


def _seq(_path, _leaf):
    return (None, None, "sp", None)


def ring_rank(rank: int, n: int, device_type: str, work_dir: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    device = _device(device_type, rank)
    mesh = make_mesh({"sp": n}, device_type)
    group = mesh.get_group("sp")
    q, k, v = _qkv(n, device)
    if rank == 0:
        print(f"{n}-way sequence parallelism, {q.shape[2]} tokens", flush=True)

    out = ring_attention(*(seq_slice(t, group) for t in (q, k, v)), group, causal=True)
    expected = _reference_attention(q, k, v, True)
    err = float((out - seq_slice(expected, group)).abs().max())
    assert err < 1e-5, err
    errs = [None] * n
    dist.all_gather_object(errs, err)
    if rank == 0:
        print(f"ring == dense reference (max err {max(errs):.1e}); "
              f"output sharded over sp ({tuple(out.shape)} a rank)", flush=True)

    # Long-context TRAINING: the zigzag layout balances causal work across
    # the ring, and flash chunks keep per-rank attention memory O(chunk·D)
    # — differentiable end to end.
    before = _launches()
    qz, kz, vz = (
        seq_slice(to_zigzag(t, n), group).detach().requires_grad_() for t in (q, k, v)
    )
    outz = ring_attention_zigzag(qz, kz, vz, group, chunk_impl="flash")
    zerr = float((outz.detach() - seq_slice(to_zigzag(expected, n), group)).abs().max())
    assert zerr < FLASH_TOL, zerr
    torch.sum(outz.float() ** 2).backward()
    grads = (qz.grad, kz.grad, vz.grad)
    assert all(bool(torch.isfinite(g_).all()) for g_ in grads)
    launches = [None] * n
    dist.all_gather_object(launches, [b - a for a, b in zip(before, _launches())])
    if rank == 0:
        k1, k2, k3 = (sum(r[i] for r in launches) for i in range(3))
        print(
            f"zigzag+flash ring gradients computed for {q.shape[2]} tokens "
            f"({n}-way balanced causal ring; max err vs reference {zerr:.1e}; "
            f"K1 launches {k1}, K2 launches {k2}, K3 launches {k3})",
            flush=True,
        )

    # Checkpoint the sp-sharded tensors.
    state = shard_pytree({"kv_cache_k": k, "kv_cache_v": v}, mesh, _seq)
    app_state = {"s": StateDict(**state)}
    Snapshot.take(f"{work_dir}/snap", app_state)
    record_taken_state(work_dir, f"{work_dir}/snap", app_state)


def restore_rank(rank: int, world: int, device_type: str, work_dir: str, take_world: int) -> None:
    device = _device(device_type, rank)
    mesh = make_mesh({"sp": world}, device_type)
    _, k, v = _qkv(take_world, device)
    zeros = {"kv_cache_k": torch.zeros_like(k), "kv_cache_v": torch.zeros_like(v)}
    target = StateDict(**shard_pytree(zeros, mesh, _seq))
    Snapshot(f"{work_dir}/snap").restore({"s": target})
    group = mesh.get_group("sp") if world > 1 else None
    for name, want in (("kv_cache_k", k), ("kv_cache_v", v)):
        assert torch.equal(target[name].to_local(), seq_slice(want, group)), name
    dist.barrier()
    if rank == 0:
        print(f"OK: sp-sharded state round-tripped onto a {world}-way mesh", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--world", type=int, default=None,
                        help="sp ranks (default: 4, or 2 on a card)")
    parser.add_argument("--timeout-s", type=float, default=600.0)
    args = parser.parse_args()
    world = args.world or default_world(args.device)
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnapshot-lc-")
    os.makedirs(work_dir, exist_ok=True)
    run_multiprocess(ring_rank, world, (args.device, work_dir), timeout_s=args.timeout_s)
    run_multiprocess(
        restore_rank, max(1, world // 2), (args.device, work_dir, world),
        timeout_s=args.timeout_s,
    )


if __name__ == "__main__":
    main()
