"""Overlap math between saved chunks and a restore target.

Pure index arithmetic over hyper-rectangles; no device code.

A *chunk* is a saved region of a global array described by ``offsets`` and
``sizes`` (one per dim). A *target* is the region being restored. For every
(chunk, target) pair the intersection box is translated into local
coordinates on both sides; the read path then copies
``chunk_view[chunk_slices] → target_buffer[target_slices]``.
``contiguous_byte_range`` says whether such a box is one run of the
C-order layout, so it can be read and copied as a flat byte range.
``shard_box`` gives the box a DTensor's local shard holds in its global
array, where the JAX package reads a shard's index.
"""

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Overlap:
    """Intersection of one saved chunk and one target region."""

    # Slices into the chunk's local coordinates.
    chunk_slices: Tuple[slice, ...]
    # Slices into the target's local coordinates.
    target_slices: Tuple[slice, ...]
    # Global coordinates of the intersection box (offsets, sizes).
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]


def compute_overlap(
    chunk_offsets: Sequence[int],
    chunk_sizes: Sequence[int],
    target_offsets: Sequence[int],
    target_sizes: Sequence[int],
) -> Optional[Overlap]:
    """Intersection of two boxes in global coordinates, or None.

    """
    chunk_slices = []
    target_slices = []
    offsets = []
    sizes = []
    for co, cs, to, ts in zip(chunk_offsets, chunk_sizes, target_offsets, target_sizes):
        start = max(co, to)
        end = min(co + cs, to + ts)
        if end <= start:
            return None
        chunk_slices.append(slice(start - co, end - co))
        target_slices.append(slice(start - to, end - to))
        offsets.append(start)
        sizes.append(end - start)
    return Overlap(
        chunk_slices=tuple(chunk_slices),
        target_slices=tuple(target_slices),
        offsets=tuple(offsets),
        sizes=tuple(sizes),
    )


def shard_box(
    global_shape: Sequence[int],
    mesh_shape: Sequence[int],
    coordinate: Sequence[int],
    placements: Sequence[Any],
) -> Tuple[List[int], List[int]]:
    """(offsets, sizes) of the local shard of a DTensor at mesh
    ``coordinate``: the public placement semantics, computed here.

    Mesh dims apply in order; ``Shard(d)`` splits the current extent of
    tensor dim ``d`` as ``torch.chunk`` does (chunks of ceil(n / k), the
    last ones shorter or empty: vocab 50257 over 4 → 12565 × 3 + 12562);
    ``Replicate`` keeps it. ``Partial`` (a pending reduction) and strided
    shards have no box of their own and raise.
    """
    from torch.distributed.tensor import Replicate, Shard

    offsets = [0] * len(global_shape)
    sizes = list(global_shape)
    for mesh_dim, placement in enumerate(placements):
        if isinstance(placement, Replicate):
            continue
        if type(placement) is not Shard:
            raise ValueError(
                f"Cannot snapshot a DTensor with placement {placement!r} on "
                f"mesh dim {mesh_dim}: only Shard and Replicate placements "
                f"describe stored values (redistribute Partial placements "
                f"to Replicate first)"
            )
        dim = placement.dim % len(global_shape)
        n_chunks = mesh_shape[mesh_dim]
        extent = sizes[dim]
        chunk = -(-extent // n_chunks)
        start = min(coordinate[mesh_dim] * chunk, extent)
        offsets[dim] += start
        sizes[dim] = min(start + chunk, extent) - start
    return offsets, sizes


def contiguous_byte_range(
    chunk_sizes: Sequence[int], chunk_slices: Tuple[slice, ...], itemsize: int
) -> Optional[Tuple[int, int]]:
    """If ``chunk_slices`` selects a C-contiguous byte range of the chunk,
    return (start_byte, end_byte); else None.

    The selection is contiguous iff every dim after the first partial dim is
    selected in full, and all dims before the first partial dim select a
    single element or are full... collapsed to the practical test: the
    selected box, flattened in C order, is one run. That holds when for some
    pivot dim d: dims < d select exactly one index each OR are full-with-
    size-1, dim d selects any range, and dims > d are selected in full.
    """
    n = len(chunk_sizes)
    # Find last dim that is not selected in full.
    pivot = -1
    for d in range(n):
        sl = chunk_slices[d]
        if not (sl.start == 0 and sl.stop == chunk_sizes[d]):
            pivot = d
    if pivot == -1:
        total = itemsize
        for s in chunk_sizes:
            total *= s
        return (0, total)
    # All dims before pivot must select a single index (size 1), otherwise
    # the flattened selection has gaps.
    for d in range(pivot):
        sl = chunk_slices[d]
        if (sl.stop - sl.start) != 1:
            return None
    # Compute strides (in elements) of the chunk.
    strides = [1] * n
    for d in range(n - 2, -1, -1):
        strides[d] = strides[d + 1] * chunk_sizes[d + 1]
    start_elem = 0
    for d in range(pivot + 1):
        start_elem += chunk_slices[d].start * strides[d]
    run_elems = (chunk_slices[pivot].stop - chunk_slices[pivot].start) * strides[pivot]
    return (start_elem * itemsize, (start_elem + run_elems) * itemsize)


def subdivide(
    offsets: Sequence[int],
    sizes: Sequence[int],
    itemsize: int,
    max_chunk_bytes: int,
) -> List[Tuple[List[int], List[int]]]:
    """Split a region into chunks of ≤ ``max_chunk_bytes`` along its largest
    dim. Returns [(offsets, sizes), ...] in global coordinates.

    The split rule is the JAX package's, so a dense array above the cap
    is stored as the same chunks by either package.
    """
    nbytes = itemsize
    for s in sizes:
        nbytes *= s
    if nbytes <= max_chunk_bytes or not sizes:
        return [(list(offsets), list(sizes))]
    dim = max(range(len(sizes)), key=lambda d: sizes[d])
    n_chunks = -(-nbytes // max_chunk_bytes)  # ceil
    n_chunks = min(n_chunks, sizes[dim])
    per = -(-sizes[dim] // n_chunks)  # ceil rows per chunk
    out = []
    pos = 0
    while pos < sizes[dim]:
        length = min(per, sizes[dim] - pos)
        o = list(offsets)
        s = list(sizes)
        o[dim] = offsets[dim] + pos
        s[dim] = length
        out.append((o, s))
        pos += length
    return out
