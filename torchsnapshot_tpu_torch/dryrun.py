"""Entry points: a one-device forward check and the multi-rank dry run.

The port of ``__graft_entry__.py``. :func:`entry` returns the flagship
transformer's forward at tiny widths with its arguments, on the card
unless the caller passes ``device="cpu"``. :func:`dryrun_multichip`
runs the JAX dry run's whole sequence over ``n`` ranks of one gloo
process group (``utils/test_utils.run_multiprocess``), each on the device
type asked for: where the JAX package forces ``n`` virtual CPU devices,
the port spawns ``n`` ranks (sharing the card when there is one card).
Every rank:

1. trains the zigzag flash-ring step on a ``dp × sp × tp`` mesh of
   ``auto_axes(n, prefer_tp=4, with_sp=True)`` (flash chunks where the
   sub-chunk passes ``resolve_flash_block``), and the Ulysses step;
2. takes the state with ``replicated=["**"]`` and restores it into an
   all-replicated template on the same mesh;
3. takes it with fingerprints, changes one leaf, takes it incrementally
   (some entries must borrow from the base) and restores that with
   ``verify_device=True``;
4. restores the first snapshot onto half the ranks (a world of its own,
   the others waiting) and onto a split into two groups, each holding
   the state sharded over its own mesh;
5. trains one DLRM step with the tables row-sharded over ``{"ep": n}``,
   takes it, and restores it into unsharded tensors and onto ``ep`` of
   half the ranks;
6. saves it through ``CheckpointManager(max_to_keep=1)`` (``save``, then
   ``async_save``), and restores the latest step.

Each check raises on a mismatch. With ``record_dir``, each rank writes
``dryrun_<rank>.json`` there: its losses, leaves checked and its launches
of each kernel (K1–K3 on the ring, K4 on the fingerprinted takes).
"""

import json
import math
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .coord import FileStore, StoreCoordinator
from .io_preparer import dtensor_box, is_dtensor
from .manager import CheckpointManager
from .manifest import ShardedArrayEntry
from .models import dlrm
from .models.transformer import (
    TransformerConfig,
    _local,
    _resolve_device,
    forward,
    init_params,
    map_leaves,
    param_leaves,
    sgd_train_step,
    shard_params,
)
from .ops import attention
from .ops import fingerprint as fingerprint_ops
from .ops.attention import resolve_flash_block
from .parallel.mesh import auto_axes, make_mesh, replicate_pytree
from .snapshot import Snapshot
from .utils.test_utils import run_multiprocess
from .utils.train_state import PytreeStateful


def entry(device: Any = None) -> Tuple:
    """A forward step of the flagship transformer and example arguments
    (``__graft_entry__.entry``'s widths), on ``device`` (the card by
    default)."""
    config = TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=16
    )
    params = init_params(config, seed=0, device=device)
    tokens = torch.zeros((2, 16), dtype=torch.int64, device=params["embed"].device)

    def fn(params, tokens):
        return forward(params, tokens, config)

    return fn, (params, tokens)


def dryrun_multichip(
    n_devices: int,
    device: Any = None,
    record_dir: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Run the dry run over ``n_devices`` gloo ranks on ``device``'s type
    (the card by default); raises if any rank's check fails."""
    device_type = _resolve_device(device).type
    with tempfile.TemporaryDirectory(prefix="dryrun-") as workdir:
        run_multiprocess(
            _dryrun_rank, n_devices, args=(device_type, workdir, record_dir), timeout_s=timeout_s
        )


def _zeros_like_global(t: Any) -> torch.Tensor:
    """Zeros of a (D)Tensor's global shape on its device."""
    return torch.zeros(tuple(t.shape), dtype=t.dtype, device=_local(t).device)


def _clone(t: Any) -> Any:
    """A copy of a (D)Tensor with its own storage, placed alike."""
    if not is_dtensor(t):
        return t.detach().clone()
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        t.to_local().detach().clone(), t.device_mesh, t.placements,
        run_check=False, shape=t.shape, stride=t.stride(),
    )


def _box_of(whole: torch.Tensor, t: Any) -> torch.Tensor:
    """``t``'s local box of the global tensor ``whole``."""
    if not is_dtensor(t):
        return whole
    offsets, sizes = dtensor_box(t)
    return whole[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]


def _check_boxes(got_tree: Any, want_tree: Any, what: str) -> int:
    """Every leaf of ``got_tree`` byte-equal to its box of the matching
    leaf of ``want_tree`` (whole tensors); returns the leaves checked."""
    n = 0
    for got, want in zip(param_leaves(got_tree), param_leaves(want_tree)):
        local = _local(got)
        expected = _box_of(want, got).contiguous()
        if local.shape != expected.shape or not torch.equal(
            local.contiguous().view(torch.uint8), expected.view(torch.uint8)
        ):
            raise AssertionError(f"{what}: leaf {n} differs from its box of the saved state")
        n += 1
    return n


def _sub_coordinator(workdir: str, name: str, rank: int, world: int) -> StoreCoordinator:
    return StoreCoordinator(FileStore(os.path.join(workdir, f"coord-{name}")), rank, world)


def _count_base_refs(snapshot: Snapshot) -> int:
    n = 0
    for entry in snapshot.get_manifest().values():
        arrays = [s.array for s in entry.shards] if isinstance(entry, ShardedArrayEntry) else [entry]
        n += sum(getattr(a, "base", None) is not None for a in arrays)
    return n


def _dryrun_rank(rank: int, world: int, device_type: str, workdir: str, record_dir: Optional[str]) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    device = device_type
    record: Dict[str, Any] = {"rank": rank, "world": world}

    # 1. The long-context train step: zigzag ring attention with flash
    # chunks where the per-rank sub-chunk admits them; then Ulysses.
    axes = auto_axes(world, prefer_tp=4, with_sp=True)
    mesh = make_mesh(axes, device_type)
    seq_len = 32
    try:
        resolve_flash_block(seq_len // (2 * axes["sp"]))
        ring_impl = "flash"
    except ValueError:
        ring_impl = "einsum"
    config = TransformerConfig(
        vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=seq_len, ring_attention="zigzag", ring_chunk_impl=ring_impl,
    )
    params = shard_params(init_params(config, seed=0, device=device), mesh)
    for p in param_leaves(params):
        p.requires_grad_()
    tokens = torch.ones((2 * axes["dp"], seq_len), dtype=torch.int64, device=device)
    params, loss = sgd_train_step(params, tokens, config, mesh)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss: {loss}")
    record.update(axes=axes, ring_impl=ring_impl, loss=float(loss))

    uly_heads = 8
    local_heads = uly_heads // axes["tp"] if uly_heads % axes["tp"] == 0 else uly_heads
    if local_heads % axes["sp"] == 0:
        uly_config = TransformerConfig(
            vocab_size=64, d_model=64, n_heads=uly_heads, n_layers=2, d_ff=128,
            max_seq_len=seq_len, ring_attention="ulysses",
        )
        uly_params = shard_params(init_params(uly_config, seed=4, device=device), mesh)
        for p in param_leaves(uly_params):
            p.requires_grad_()
        _, uly_loss = sgd_train_step(uly_params, tokens, uly_config, mesh)
        if not math.isfinite(float(uly_loss)):
            raise AssertionError(f"non-finite ulysses loss: {uly_loss}")
        record["ulysses_loss"] = float(uly_loss)
    record["ring_launches"] = _launches()

    # 2. The replicated take and its restore into a replicated template.
    state = map_leaves(lambda t: t.detach(), params)
    snap = os.path.join(workdir, "snap")
    Snapshot.take(snap, {"m": PytreeStateful(state)}, replicated=["**"])
    replicated = PytreeStateful(replicate_pytree(map_leaves(_zeros_like_global, state), mesh))
    Snapshot(snap).restore({"m": replicated})
    whole = map_leaves(lambda t: t.to_local(), replicated.tree)
    record["replicated_leaves"] = _check_boxes(state, whole, "replicated restore")

    # 3. Incremental take over the same mesh: one leaf changes, the rest
    # borrow from the base; the restore is fingerprint-verified on the
    # device.
    base = Snapshot.take(
        os.path.join(workdir, "snap-fp"), {"m": PytreeStateful(state)},
        replicated=["**"], fingerprint=True,
    )
    stepped = map_leaves(_clone, state)
    with torch.no_grad():
        stepped["embed"].to_local().add_(1)
    inc = Snapshot.take(
        os.path.join(workdir, "snap-inc"), {"m": PytreeStateful(stepped)},
        replicated=["**"], base=base,
    )
    record["incremental_refs"] = _count_base_refs(inc)
    if record["incremental_refs"] == 0:
        raise AssertionError("incremental take deduplicated nothing")
    inc_holder = PytreeStateful(replicate_pytree(map_leaves(_zeros_like_global, stepped), mesh))
    inc.restore({"m": inc_holder}, verify_device=True)
    stepped_whole = map_leaves(lambda t: t.to_local(), inc_holder.tree)
    _check_boxes(stepped, stepped_whole, "incremental restore")
    if torch.equal(stepped_whole["embed"], whole["embed"]):
        raise AssertionError("the incremental restore lost the changed leaf")

    # 4. Elastic: onto half the ranks (a world of its own; the rest wait),
    # then onto a split into two groups of half, each with its own mesh.
    half = max(1, world // 2)
    half_axes = auto_axes(half, prefer_tp=2, with_sp=False)
    half_mesh = make_mesh(half_axes, device_type, ranks=list(range(half)))
    if half_mesh is not None:
        holder = PytreeStateful(shard_params(map_leaves(torch.zeros_like, whole), half_mesh))
        Snapshot(snap).restore({"m": holder}, coord=_sub_coordinator(workdir, "half", rank, half))
        record["half_leaves"] = _check_boxes(holder.tree, whole, "half-ranks restore")
    dist.barrier()
    groups = [list(range(0, half)), list(range(half, 2 * half))]
    split = [make_mesh(half_axes, device_type, ranks=g) for g in groups]
    own = next((m for m in split if m is not None), None)
    template = map_leaves(torch.zeros_like, whole)
    # A rank outside both groups (an odd world) restores unsharded.
    holder = PytreeStateful(shard_params(template, own) if own is not None else template)
    Snapshot(snap).restore({"m": holder})
    record["split_leaves"] = _check_boxes(holder.tree, whole, "split restore")

    # 5. Expert parallelism: a DLRM step with row-sharded tables and
    # sharded momentum, a take, and restores unsharded and onto ep of
    # half the ranks.
    ep_mesh = make_mesh({"ep": world}, device_type)
    dcfg = dlrm.DLRMConfig(
        table_rows={"a": 8 * world, "b": 16 * world}, embed_dim=8, dense_in=4,
        bag_len=2, bottom_mlp=(8, 8), top_mlp=(8, 1),
    )
    dense_params = dlrm.init_params(dcfg, seed=1, device=device)
    dparams = dlrm.shard_params(dense_params, ep_mesh)
    dmom = dlrm.shard_params(dlrm.init_momentum(dense_params), ep_mesh)
    del dense_params
    dense, sparse, labels = dlrm.synthetic_batch(dcfg, 4, seed=2, device=device)
    dparams, dmom, dloss = dlrm.sgd_momentum_train_step(
        dparams, dmom, dense, sparse, labels, dcfg, ep_mesh
    )
    if not math.isfinite(float(dloss)):
        raise AssertionError(f"non-finite DLRM loss: {dloss}")
    record["dlrm_loss"] = float(dloss)
    ep_snap = os.path.join(workdir, "ep")
    Snapshot.take(ep_snap, {"m": PytreeStateful(dparams)})
    unsharded = PytreeStateful(map_leaves(_zeros_like_global, dparams))
    Snapshot(ep_snap).restore({"m": unsharded})
    dwhole = unsharded.tree
    record["dlrm_leaves"] = _check_boxes(dparams, dwhole, "DLRM unsharded restore")
    ep_half = make_mesh({"ep": half}, device_type, ranks=list(range(half)))
    if ep_half is not None:
        holder = PytreeStateful(dlrm.shard_params(map_leaves(torch.zeros_like, dwhole), ep_half))
        Snapshot(ep_snap).restore({"m": holder}, coord=_sub_coordinator(workdir, "ep", rank, half))
        _check_boxes(holder.tree, dwhole, "DLRM narrower-ep restore")
    dist.barrier()

    # 6. The manager over the same sharded state: save, async save,
    # retention, restore of the latest step.
    mgr = CheckpointManager(os.path.join(workdir, "run"), max_to_keep=1)
    mgr.save(1, {"m": PytreeStateful(dparams)})
    mgr.async_save(2, {"m": PytreeStateful(dparams)}).wait()
    dist.barrier()  # rank 0 prunes after the others are released
    if mgr.all_steps() != [2]:
        raise AssertionError(f"retention kept {mgr.all_steps()}, not [2]")
    holder = PytreeStateful(dlrm.shard_params(map_leaves(torch.zeros_like, dwhole), ep_mesh))
    if mgr.restore({"m": holder}) != 2:
        raise AssertionError("the manager did not restore step 2")
    _check_boxes(holder.tree, dwhole, "manager restore")

    record["launches"] = _launches()
    if record_dir is not None:
        with open(os.path.join(record_dir, f"dryrun_{rank}.json"), "w") as f:
            json.dump(record, f)


def _launches() -> Dict[str, int]:
    return {
        "flash_fwd": attention.flash_forward_launches,
        "flash_bwd_dq": attention.flash_bwd_dq_launches,
        "flash_bwd_dkv": attention.flash_bwd_dkv_launches,
        "xs128_box": fingerprint_ops.fingerprint_box_launches,
        "xs128_chunked": fingerprint_ops.fingerprint_chunked_launches,
    }
