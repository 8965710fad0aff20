"""Chunk pushdown planning: which content chunks a shard actually needs.

A chunk-stored object (chunkstore.py) is a flat C-order byte stream
partitioned into content-addressed records. A restoring client that
only needs some SLICES of the stored array (a differently-meshed
restore: each mesh rank owns a shard of every parameter) historically
fetched EVERY record of every overlapping stored object — whole-object
amplification. This module computes the minimal record subset from the
slice geometry, and it is the single source of truth for BOTH sides of
the read plane:

- the local cut in ``io_preparer`` (direct restores and served restores
  alike read only the selected records), and
- the snapserve ``plan`` op (``server._op_plan``): a client posts the
  record layout + the slice boxes its rank needs and receives exactly
  the record-index set and merged byte ranges to fetch.

One implementation means the RPC answer and the local ground truth
cannot drift — ``tests/test_torch_snapfleet.py`` pins the equality.

The hull math is conservative by construction: a slice box's flat byte
footprint is covered by the closed interval from its first to its last
element (`slice_byte_hull`), a superset of the exact strided footprint.
Records overlapping the hull are fetched; the scatter only ever reads
the box elements themselves, so unread gap bytes in the assembly
buffer are never observed. Correctness never depends on the hull being
tight — only the saved bytes do.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PushdownPlan",
    "slice_byte_hull",
    "merge_intervals",
    "needed_intervals",
    "select_records",
    "plan_from_doc",
]


@dataclass
class PushdownPlan:
    """The record subset a shard needs: indices into the entry's record
    list, the merged byte intervals that justified them, and the byte
    accounting (``selected_bytes`` / ``total_bytes`` — the pushdown
    win is their ratio)."""

    indices: List[int]
    intervals: List[Tuple[int, int]]
    selected_bytes: int
    total_bytes: int

    def to_doc(self) -> Dict[str, Any]:
        return {
            "indices": list(self.indices),
            "intervals": [[int(a), int(b)] for a, b in self.intervals],
            "selected_bytes": int(self.selected_bytes),
            "total_bytes": int(self.total_bytes),
        }


def slice_byte_hull(
    shape: Sequence[int],
    box: Sequence[Tuple[int, int]],
    itemsize: int,
) -> Optional[Tuple[int, int]]:
    """Byte interval ``[lo, hi)`` covering every element of the slice
    box ``[(start, stop), ...]`` in the C-order flat layout of an array
    of ``shape``. ``None`` for an empty box. The hull spans first to
    last element inclusive — a conservative superset of the strided
    footprint (every box element's flat offset lies within it)."""
    if len(box) != len(shape):
        raise ValueError(
            f"box rank {len(box)} != array rank {len(shape)}"
        )
    if not shape:
        # 0-d array: the whole (single-element) payload.
        return (0, itemsize)
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * int(shape[d + 1])
    first = 0
    last = 0
    for (start, stop), stride, dim in zip(box, strides, shape):
        start, stop = int(start), int(stop)
        if stop <= start or start < 0 or stop > int(dim):
            return None
        first += start * stride
        last += (stop - 1) * stride
    return (first * itemsize, (last + 1) * itemsize)


def merge_intervals(
    intervals: Sequence[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """Sort and coalesce overlapping/adjacent ``[lo, hi)`` intervals."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted((int(a), int(b)) for a, b in intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def needed_intervals(
    shape: Sequence[int],
    boxes: Sequence[Sequence[Tuple[int, int]]],
    itemsize: int,
) -> List[Tuple[int, int]]:
    """Merged byte intervals of the stored object's flat payload that
    the given slice boxes (one per target-region overlap) touch."""
    hulls = []
    for box in boxes:
        hull = slice_byte_hull(shape, box, itemsize)
        if hull is not None:
            hulls.append(hull)
    return merge_intervals(hulls)


def select_records(
    record_sizes: Sequence[int],
    intervals: Sequence[Tuple[int, int]],
) -> PushdownPlan:
    """Indices of the records (consecutive byte runs of sizes
    ``record_sizes``) that intersect any needed interval. Intervals
    must be sorted and disjoint (:func:`merge_intervals` output)."""
    merged = merge_intervals(intervals)
    indices: List[int] = []
    selected = 0
    offset = 0
    it = 0
    for i, n in enumerate(record_sizes):
        n = int(n)
        lo, hi = offset, offset + n
        while it < len(merged) and merged[it][1] <= lo:
            it += 1
        if it < len(merged) and merged[it][0] < hi and n > 0:
            indices.append(i)
            selected += n
        offset += n
    return PushdownPlan(
        indices=indices,
        intervals=merged,
        selected_bytes=selected,
        total_bytes=offset,
    )


def plan_from_doc(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The ``plan`` op's server-side compute: a pure function of the
    request document, no backend access. Request::

        {"shape": [d0, ...], "itemsize": k,
         "record_sizes": [n0, n1, ...],
         "boxes": [[[start, stop], ...], ...]}

    Response: :meth:`PushdownPlan.to_doc`. Malformed documents raise
    ``ValueError`` (marshalled to the client as a backend error)."""
    try:
        shape = [int(d) for d in doc["shape"]]
        itemsize = int(doc["itemsize"])
        record_sizes = [int(n) for n in doc["record_sizes"]]
        boxes = [
            [(int(a), int(b)) for a, b in box] for box in doc["boxes"]
        ]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed plan request: {e!r}") from e
    if itemsize <= 0:
        raise ValueError(f"malformed plan request: itemsize {itemsize}")
    intervals = needed_intervals(shape, boxes, itemsize)
    return select_records(record_sizes, intervals).to_doc()
