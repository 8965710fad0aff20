"""Differentiable collectives over one ``torch.distributed`` process group.

The JAX package has no counterpart: under ``shard_map`` and GSPMD, XLA
inserts its collectives and differentiates them. Here each rank runs its
own local function, so the collectives that the sequence- and
tensor-parallel paths need are small ``torch.autograd.Function``s:

- :func:`rotate` — the ring hop: send to the next rank of the group,
  receive from the previous; its backward rotates the cotangent back;
- :func:`all_to_all` — the tiled all-to-all of Ulysses (split one dim
  across the group, concatenate another); its backward is the inverse
  all-to-all;
- :func:`copy_to_group` / :func:`reduce_from_group` — Megatron's pair:
  identity forward with all-reduce backward, and all-reduce forward with
  identity backward;
- :func:`gather_from_group` — an all-gather along one dim; its backward
  reduce-scatters the cotangent, or, where every rank of the group
  repeats the same work on the gathered value, keeps the rank's own
  slice of it.

Every rank of the group must call each helper in the same order, forward
and backward. The autograd engine runs a backward only for outputs that
reach the loss, so a caller whose ranks use different outputs (a ring
that skips future chunks on some ranks) ties them to its result with
:func:`keep_alive`.

Transport: on a gloo group a CUDA tensor is copied to the host, sent,
and the result copied back — a rule on the group's backend, not a
fallback after a failure — so ranks that share one card (NCCL refuses
two ranks on one GPU) run these paths. Gloo's point-to-point refuses
device memory (torch 2.11; ``tools/gloo_cuda_probe.py``), and its other
collectives copy it to the host themselves, so one rule serves all. The
kernels still run on the card. ``sent_bytes`` counts the bytes this
process hands to each kind of collective, and ``staged_bytes`` the part
of them that went through host memory.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Bytes this process handed to each kind of collective, and how many of
# them were staged through host memory (CUDA tensors on a gloo group).
sent_bytes: Dict[str, int] = {
    "rotate": 0, "all_to_all": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
}
staged_bytes = 0


def reset_counts() -> None:
    global staged_bytes
    for kind in sent_bytes:
        sent_bytes[kind] = 0
    staged_bytes = 0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to_wire(x: torch.Tensor, group: dist.ProcessGroup, kind: str) -> torch.Tensor:
    """``x`` as the group's backend takes it: contiguous, and on the host
    when a gloo group is handed a CUDA tensor. Counts the bytes."""
    global staged_bytes
    x = x.contiguous()
    sent_bytes[kind] += _nbytes(x)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        staged_bytes += _nbytes(x)
        return x.cpu()
    return x


def all_reduce_(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (not differentiable); returns ``x``."""
    wire = _to_wire(x, group, "all_reduce")
    dist.all_reduce(wire, group=group)
    if wire is not x:
        x.copy_(wire)
    return x


def _rotate(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup, shift: int) -> List[torch.Tensor]:
    """Send each tensor to the rank ``shift`` places on in the group and
    receive its counterpart from the rank ``shift`` places back, all in
    one batch of point-to-point operations."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    ops, received = [], []
    for t in tensors:
        wire = _to_wire(t, group, "rotate")
        buf = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, dst, group))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
        received.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(received, tensors)]


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_rotate(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_rotate(grads, ctx.group, -1))


def rotate(*tensors: torch.Tensor, group: dist.ProcessGroup) -> Tuple[torch.Tensor, ...]:
    """Each rank's ``tensors`` as held by the previous rank of ``group``:
    rank i sends to (i+1) mod n and receives from (i−1) mod n, as JAX's
    ``ppermute`` over ``[(j, (j+1) % n)]``."""
    return _Rotate.apply(group, *tensors)


class _KeepAlive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad, *_):
        return (grad, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.shapes))


def keep_alive(out: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
    """``out``, with ``tensors`` tied to it: the backward of whatever made
    ``tensors`` runs (with zero cotangents where ``out`` does not use
    them) on every rank that differentiates ``out``."""
    return _KeepAlive.apply(out, *tensors)


def _all_to_all(x: torch.Tensor, group: dist.ProcessGroup, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"all_to_all splits dim {split_dim} of {tuple(x.shape)} into {n} parts"
        )
    # [n, ...chunk]: part j goes to rank j; part j of the result came from it.
    parts = torch.stack(x.chunk(n, dim=split_dim))
    wire = _to_wire(parts, group, "all_to_all")
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return torch.cat(out.to(x.device).unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(grad, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group: dist.ProcessGroup, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split into n parts along
    ``split_dim``, part j sent to rank j, and the parts received
    concatenated along ``concat_dim`` in rank order."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Identity forward, all-reduce backward: the input of a
    column-parallel product, whose ranks each add a part of its gradient."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward: the output of a
    row-parallel product, or a loss summed over the ranks' data."""
    return _ReduceFromGroup.apply(x, group)


def chunk_sizes(full: int, n: int) -> List[int]:
    """Sizes of the n parts of ``full`` as ``torch.chunk`` (and a
    DTensor ``Shard``) splits it: ceil(full / n) each, the last ones
    shorter or empty."""
    step = -(-full // n)
    return [max(0, min(step, full - r * step)) for r in range(n)]


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if x.shape[dim] == size:
        return x
    pad = list(x.shape)
    pad[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(pad)], dim=dim)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, full, reduce_grad):
        n = dist.get_world_size(group)
        sizes = chunk_sizes(full, n)
        ctx.args = (group, dim, sizes, reduce_grad)
        wire = _to_wire(_pad_to(x, dim, sizes[0]).movedim(dim, 0), group, "all_gather")
        out = wire.new_empty((n * wire.shape[0], *wire.shape[1:]))
        dist.all_gather_into_tensor(out, wire, group=group)
        parts = out.to(x.device).chunk(n)
        return torch.cat([p[:s] for p, s in zip(parts, sizes)]).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim, sizes, reduce_grad = ctx.args
        me = dist.get_rank(group)
        offset = sum(sizes[:me])
        if not reduce_grad:
            return grad.narrow(dim, offset, sizes[me]), None, None, None, None
        parts = grad.movedim(dim, 0).split(sizes)
        padded = torch.cat([_pad_to(p, 0, sizes[0]) for p in parts])
        wire = _to_wire(padded, group, "reduce_scatter")
        out = wire.new_empty((sizes[0], *wire.shape[1:]))
        dist.reduce_scatter_tensor(out, wire, group=group)
        return out.to(grad.device)[: sizes[me]].movedim(0, dim), None, None, None, None


def gather_from_group(
    x: torch.Tensor,
    group: dist.ProcessGroup,
    dim: int,
    full: int,
    reduce_grad: bool = True,
) -> torch.Tensor:
    """The ranks' parts of a tensor, concatenated along ``dim`` in rank
    order into its ``full`` extent (parts split as :func:`chunk_sizes`).

    Backward: with ``reduce_grad`` the cotangents of the ranks are summed
    and each rank keeps its part (reduce-scatter) — right when each rank
    uses the gathered value for work of its own; without it each rank
    keeps its part of its own cotangent — right when every rank repeats
    the same work on it, so that the cotangents are alike."""
    return _GatherFromGroup.apply(x, group, dim, full, reduce_grad)


def group_of(mesh: Optional[object], name: str) -> Optional[dist.ProcessGroup]:
    """The process group of mesh dim ``name``, or None when the mesh has
    no such dim or it has one rank."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    if mesh.size(mesh.mesh_dim_names.index(name)) == 1:
        return None
    return mesh.get_group(name)
