"""DeviceMesh and DTensor helpers for snapshot-friendly training programs.

The checkpointing core is mesh-agnostic (it reads each DTensor's mesh and
placements), but training programs and the checks need one way to build
meshes and place trees. Axis conventions, as in the JAX package:

- ``dp`` — data parallel (the batch dim);
- ``sp`` — sequence parallel (activations' sequence dim);
- ``tp`` — tensor parallel (weight matrices' hidden dims).

A *spec* names, per tensor dim, the mesh dim that shards it, or None:
``(None, "tp")`` shards dim 1 over ``tp`` and replicates over the other
mesh dims, as the JAX package's ``PartitionSpec(None, "tp")`` does.
"""

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..resharding import shard_box

Spec = Optional[Sequence[Optional[str]]]


def make_mesh(
    axis_sizes: Dict[str, int],
    device_type: str = "cuda",
    ranks: Optional[Sequence[int]] = None,
) -> Any:
    """A DeviceMesh with named dims, e.g. ``make_mesh({"dp": 2, "tp": 4})``.

    Over every rank of the initialised ``torch.distributed`` world by
    default; the axis sizes must then multiply to the world size. With
    ``ranks`` (JAX's ``devices=``) it spans those ranks only, in that
    order, and the axis sizes must multiply to their count. Building the
    mesh creates process groups, a collective of the whole world: every
    rank calls it, and a rank outside ``ranks`` gets None. The mesh dims'
    groups take the default group's backend (a gloo world stays gloo,
    whatever ``device_type``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape = tuple(axis_sizes.values())
    n = 1
    for size in shape:
        n *= size
    have = dist.get_world_size() if ranks is None else len(ranks)
    if n != have:
        raise ValueError(f"Mesh {dict(axis_sizes)} needs {n} ranks; {have} were given.")
    if ranks is None:
        return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_sizes))
    mesh = DeviceMesh(
        device_type, torch.tensor(list(ranks)).reshape(shape), mesh_dim_names=tuple(axis_sizes)
    )
    return mesh if dist.get_rank() in ranks else None


def auto_axes(n_devices: int, prefer_tp: int = 2, with_sp: bool = False) -> Dict[str, int]:
    """A reasonable factorization of ``n_devices`` into dp (× sp) × tp."""
    tp = 1
    for cand in range(min(prefer_tp, n_devices), 0, -1):
        if n_devices % cand == 0:
            tp = cand
            break
    rem = n_devices // tp
    if not with_sp:
        return {"dp": rem, "tp": tp}
    sp = 2 if rem % 2 == 0 else 1
    return {"dp": rem // sp, "sp": sp, "tp": tp}


def placements_for(mesh: Any, spec: Spec) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on the
    mesh dim that ``spec[d]`` names, ``Replicate`` on every other."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    placements = [Replicate() for _ in range(mesh.ndim)]
    for dim, name in enumerate(spec or ()):
        if name is None:
            continue
        if name not in names:
            raise ValueError(f"spec {tuple(spec)} names {name!r}; the mesh has {names}")
        placements[names.index(name)] = Shard(dim)
    return tuple(placements)


def _place(leaf: torch.Tensor, mesh: Any, spec: Spec) -> Any:
    from torch.distributed.tensor import DTensor

    placements = placements_for(mesh, spec)
    offsets, sizes = shard_box(
        list(leaf.shape), list(mesh.shape), mesh.get_coordinate(), placements
    )
    box = tuple(slice(o, o + s) for o, s in zip(offsets, sizes))
    # A copy of this rank's box, so the full tensor can be freed.
    local = leaf.detach()[box].clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=leaf.shape, stride=leaf.stride()
    )


def shard_pytree(
    tree: Any, mesh: Any, rules: Callable[[Tuple[str, ...], Any], Spec]
) -> Any:
    """Place every tensor of ``tree`` (nested dicts and lists) per
    ``rules(path, leaf) -> spec`` (None replicates) as a DTensor on
    ``mesh``. Every rank holds the full tree; each keeps its own box. No
    communication: ``DTensor.from_local`` with the global shape and
    stride, not ``distribute_tensor``, which scatters from one rank."""

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        if isinstance(node, torch.Tensor):
            return _place(node, mesh, rules(path, node))
        return node

    return walk(tree, ())


def replicate_pytree(tree: Any, mesh: Any) -> Any:
    return shard_pytree(tree, mesh, lambda *_: None)
