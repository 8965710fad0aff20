"""xs128 content fingerprints: the hand-written CUDA kernels K4 and K5
and their plain versions.

``fingerprint_boxes(items)`` computes the four u32 lanes of each
tensor's payload (or of the sub-box ``box`` of it) in a list of
``(tensor, box)``; ``fingerprint_chunked_many(items, chunk_bytes)``
computes them for every ``chunk_bytes`` slice of each tensor's payload,
indices restarting at each chunk. The payload is the tensor's stored
bytes read as little-endian u32 words, the tail zero-padded, so the
result depends on the bytes alone, whatever the dtype. On CUDA tensors
the wrappers launch ``csrc/fingerprint.cu`` once for the whole batch
(the Hopper port of the JAX package's XLA-jitted
``_fingerprint_device_jit`` and ``_fingerprint_device_chunked_jit``,
``torchsnapshot_tpu/fingerprint.py`` :123 and :219); on CPU tensors they
compute the plain versions item by item. There is no fallback to the
plain versions for a CUDA tensor. ``fingerprint_box`` and
``fingerprint_chunked`` are batches of one.

A batch is a list of segments (one a tensor or box for K4, one a chunk
for K5), planned on the host by :func:`plan_segments` with numpy and
copied to the card as one small table.

Results are int32 tensors holding the u32 bits ((n, 4) rows), on the
input's device: torch's uint32 is partial, and the caller copies them to
the host in one transfer.

The plain versions use int64 masked to 32 bits (torch cannot build u32
ranges on the CPU), multiplying in 16-bit halves so that no product
passes 2⁶³, over bounded batches of the payload: a large leaf never
makes an intermediate of its own size.

``fingerprint_box_launches`` and ``fingerprint_chunked_launches`` count
kernel launches (one a batch on a device); ``fingerprint_box_segments``
and ``fingerprint_chunked_segments`` count the non-empty tensors or
boxes (K4) and the non-empty chunked tensors (K5) those launches
fingerprinted. Plain calls count nothing.
"""

import ctypes
import math
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import build

# Kernel launches by the CUDA wrappers in this process, and the tensors
# or boxes (K4) and chunked tensors (K5) they fingerprinted.
fingerprint_box_launches = 0
fingerprint_chunked_launches = 0
fingerprint_box_segments = 0
fingerprint_chunked_segments = 0

N_LANES = 4
GOLD = 0x9E3779B1
SALT = 0x85EBCA77
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
_MASK = 0xFFFFFFFF
SALTS = tuple((SALT * k + 1) & _MASK for k in range(N_LANES))

# Bytes of payload the plain versions turn into words at a time.
_PLAIN_BATCH_BYTES = 16 << 20

# (offset, total, run, stride) in bytes: the payload is `total` bytes in
# runs of `run` bytes, `stride` apart, from `offset`; run >= total is one
# contiguous run.
Layout = Tuple[int, int, int, int]


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype.is_complex:
        raise ValueError(f"no fingerprint for dtype {x.dtype}: complex payloads have no word view")


def box_layout(shape: Sequence[int], itemsize: int, box: Optional[Sequence[Tuple[int, int]]]) -> Optional[Layout]:
    """The layout of box ``box`` ((start, stop) per dim, None for all) of
    a C-contiguous array of ``shape``: one run, or runs along the one dim
    whose range is cut (every other dim whole), as the JAX package's
    ``subdivide`` splits a region. None when no such layout fits."""
    shape = list(shape)
    if box is None:
        box = [(0, n) for n in shape]
    sizes = [b - a for a, b in box]
    total = itemsize * math.prod(sizes)
    if total == 0:
        return (0, 0, 0, 0)
    inner = [itemsize] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        inner[d] = inner[d + 1] * shape[d + 1]
    offset = sum(a * inner[d] for d, (a, _) in enumerate(box))
    cut = [d for d in range(len(shape)) if sizes[d] != shape[d]]
    if not cut:
        return (offset, total, total, total)
    last = cut[-1]
    if all(sizes[d] == 1 for d in range(last)):
        return (offset, total, total, total)
    if len(cut) == 1:
        runs = math.prod(shape[:last])
        return (offset, total, total // runs, shape[last] * inner[last])
    return None


# ------------------------------------------------------------ plain versions


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2³²`` for int64 values in [0, 2³²), by 16-bit halves
    of ``a``: each partial product stays below 2⁴⁸."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mulmod32(h, M1)
    h = h ^ (h >> 13)
    h = _mulmod32(h, M2)
    return h ^ (h >> 16)


def _weights(index: torch.Tensor, lane: int) -> torch.Tensor:
    return _mix32((_mulmod32(index, GOLD) + SALTS[lane]) & _MASK)


def _words(raw: torch.Tensor) -> torch.Tensor:
    """Little-endian u32 words (as int64) of a uint8 tensor whose length
    is a multiple of 4."""
    return raw.contiguous().clone().view(torch.int32).to(torch.int64) & _MASK


def _as_int32(lanes: torch.Tensor) -> torch.Tensor:
    lanes = lanes & _MASK
    return torch.where(lanes >= 1 << 31, lanes - (1 << 32), lanes).to(torch.int32)


def flat_bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of ``x`` in C order, a flat uint8 view when ``x`` is
    contiguous (whatever strides its size-1 dims carry)."""
    if x.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=x.device)
    x = x.detach().contiguous()
    return x.as_strided((x.numel(),), (1,)).view(torch.uint8)


def _byte_stream(x: torch.Tensor, layout: Layout) -> Iterator[torch.Tensor]:
    """The payload bytes of ``layout`` over contiguous ``x``, in order,
    in pieces of at most ``_PLAIN_BATCH_BYTES``."""
    offset, total, run, stride = layout
    flat = flat_bytes(x)
    step = _PLAIN_BATCH_BYTES
    if run >= total:
        for lo in range(0, total, step):
            yield flat[offset + lo : offset + min(total, lo + step)]
        return
    n_runs = total // run
    if run > step:
        for r in range(n_runs):
            base = offset + r * stride
            for lo in range(0, run, step):
                yield flat[base + lo : base + min(run, lo + step)]
        return
    per = max(1, step // run)
    for r0 in range(0, n_runs, per):
        nr = min(per, n_runs - r0)
        yield torch.as_strided(flat, (nr, run), (stride, 1), flat.storage_offset() + offset + r0 * stride).reshape(-1)


def fingerprint_box_reference(x: torch.Tensor, box: Optional[Sequence[Tuple[int, int]]] = None) -> torch.Tensor:
    """The plain K4: the (4,) lanes of box ``box`` of ``x``, computed on
    ``x``'s device (the wrapper calls it for CPU tensors only)."""
    _check_dtype(x)
    if not x.is_contiguous():
        x = x.contiguous()
    layout = box_layout(x.shape, x.element_size(), box)
    if layout is None:
        x = x[tuple(slice(a, b) for a, b in box)].contiguous()
        layout = box_layout(x.shape, x.element_size(), None)
    device = x.device
    lanes = torch.zeros(N_LANES, dtype=torch.int64, device=device)
    carry = torch.empty(0, dtype=torch.uint8, device=device)
    start = 0

    def fold(raw: torch.Tensor) -> None:
        nonlocal start
        w = _words(raw)
        index = torch.arange(start, start + w.numel(), dtype=torch.int64, device=device) & _MASK
        for k in range(N_LANES):
            lanes[k] += _mulmod32(w, _weights(index, k)).sum() & _MASK
        start += w.numel()

    for piece in _byte_stream(x, layout):
        raw = torch.cat([carry, piece]) if carry.numel() else piece
        whole = raw.numel() // 4 * 4
        if whole:
            fold(raw[:whole])
        carry = raw[whole:].clone()
    if carry.numel():
        fold(torch.cat([carry, torch.zeros(4 - carry.numel(), dtype=torch.uint8, device=device)]))
    return _as_int32(lanes)


def fingerprint_chunked_reference(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """The plain K5: the (n_chunks, 4) lanes of every ``chunk_bytes``
    slice of ``x``'s payload, indices restarting at each, computed on
    ``x``'s device (the wrapper calls it for CPU tensors only)."""
    _check_dtype(x)
    _check_chunk_bytes(chunk_bytes)
    flat = flat_bytes(x)
    total = flat.numel()
    chunk_words = chunk_bytes // 4
    n_full, n_chunks = total // chunk_bytes, -(-total // chunk_bytes)
    device = x.device
    out = torch.zeros((n_chunks, N_LANES), dtype=torch.int64, device=device)
    index = torch.arange(chunk_words, dtype=torch.int64, device=device)
    weights = [_weights(index, k) for k in range(N_LANES)]
    per = max(1, (_PLAIN_BATCH_BYTES // 4) // chunk_words)
    for r0 in range(0, n_full, per):
        r1 = min(n_full, r0 + per)
        rows = _words(flat[r0 * chunk_bytes : r1 * chunk_bytes]).reshape(r1 - r0, chunk_words)
        for k in range(N_LANES):
            out[r0:r1, k] = _mulmod32(rows, weights[k][None, :]).sum(dim=1)
    if n_chunks > n_full:
        tail = torch.zeros(chunk_bytes, dtype=torch.uint8, device=device)
        rest = flat[n_full * chunk_bytes :]
        tail[: rest.numel()] = rest
        words = _words(tail)
        for k in range(N_LANES):
            out[n_full, k] = _mulmod32(words, weights[k]).sum()
    return _as_int32(out)


# ------------------------------------------------------------------ kernels

# The kernel's tiling (kTileVecs * 4 and kGroup in csrc/fingerprint.cu):
# a fast block reads tiles of TILE_WORDS word indices of up to GROUP
# segments with the same weights. A general block takes
# GENERAL_BLOCK_WORDS words of one segment (the kernel strides over the
# blocks the plan gives a segment).
TILE_WORDS = 2048
GROUP = 32
GENERAL_BLOCK_WORDS = 8192
MODE_WORD, MODE_BYTES = 0, 1
# A fast block runs over consecutive tiles of its group: about the fast
# bytes over RUN_BLOCKS (two waves of four blocks on the H100's 132 SMs)
# a block, at most MAX_RUN_BYTES, at least one tile.
RUN_BLOCKS = 2 * 4 * 132
MAX_RUN_BYTES = 1 << 20


class SegmentPlan(NamedTuple):
    """One batch's table, as ``xs128_batch`` reads it (int64):
    ``fast_addr, fast_vecs, fast_row`` (n_fast each, sorted by length,
    descending), ``group_first, group_last, group_tile0, group_tiles,
    group_per`` (n_groups each), ``group_block`` (n_groups + 1),
    ``gen_addr, gen_total, gen_run, gen_stride, gen_w0, gen_w1, gen_row,
    gen_mode`` (n_general each) and ``gen_block`` (n_general + 1)."""

    table: np.ndarray
    n_fast: int
    n_groups: int
    n_general: int
    fast_blocks: int
    general_blocks: int
    # Word indices whose weights the shared groups compute (once a tile),
    # words the fast blocks read, of them the words of lone groups (each
    # word's weights computed for it), and words the general blocks read.
    weight_indices: int
    fast_words: int
    lone_words: int
    general_words: int

    def sections(self) -> dict:
        """The table's arrays by name."""
        sizes = [("fast_addr", self.n_fast), ("fast_vecs", self.n_fast), ("fast_row", self.n_fast)]
        sizes += [(name, self.n_groups) for name in (
            "group_first", "group_last", "group_tile0", "group_tiles", "group_per")]
        sizes.append(("group_block", self.n_groups + 1))
        sizes += [(name, self.n_general) for name in (
            "gen_addr", "gen_total", "gen_run", "gen_stride", "gen_w0", "gen_w1", "gen_row", "gen_mode")]
        sizes.append(("gen_block", self.n_general + 1))
        out, pos = {}, 0
        for name, n in sizes:
            out[name] = self.table[pos : pos + n]
            pos += n
        return out


def _prefix(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(counts, dtype=np.int64)])


def plan_segments(addr, total, run, stride, row) -> SegmentPlan:
    """The table of a batch of segments, one entry an array element:
    segment s is the stream of ``total[s]`` bytes in runs of ``run[s]``
    bytes ``stride[s]`` apart from address ``addr[s]`` (``run >= total``:
    one contiguous run), its lanes added into output row ``row[s]``.

    A contiguous 16-byte-aligned segment goes to the fast path for its
    whole 16-byte vectors. The fast segments are sorted by length and cut
    into runs of ``GROUP``; each run's tiles of ``TILE_WORDS`` indices
    split into a shared group (the tiles its second segment reaches, all
    its segments walked with one set of weights) and a lone group (the
    first segment's remaining tiles, each word's weights computed for
    it). A group's blocks each take ``group_per`` consecutive tiles.
    Everything else, and the last 0–3
    words of every fast segment, goes to the general path, words
    [w0, w1) of the stream, ``GENERAL_BLOCK_WORDS`` a block. Vectorized:
    no Python loop per segment, tile or chunk."""
    addr, total, run, stride, row = (np.asarray(a, dtype=np.int64).reshape(-1)
                                     for a in (addr, total, run, stride, row))
    tile_vecs = TILE_WORDS // 4
    contiguous = run >= total
    vecs = np.where(contiguous & (addr % 16 == 0), total // 16, 0)
    words = (total + 3) // 4
    w0 = vecs * 4
    fast = np.flatnonzero(vecs > 0)
    fast = fast[np.argsort(-vecs[fast], kind="stable")]
    starts = np.arange(0, fast.size, GROUP, dtype=np.int64)
    ends = np.minimum(starts + GROUP, fast.size)
    sorted_vecs = np.append(vecs[fast], 0)  # a 0 past the end: no second segment
    tiles = -(-sorted_vecs[starts] // tile_vecs)
    shared = np.where(ends - starts > 1, -(-sorted_vecs[starts + 1] // tile_vecs), 0)
    # Per run: (shared group, lone group); empty ones dropped.
    g_first = np.repeat(starts, 2)
    g_last = np.stack([ends, starts + 1], axis=1).reshape(-1)
    g_tile0 = np.stack([np.zeros_like(shared), shared], axis=1).reshape(-1)
    g_tiles = np.stack([shared, tiles - shared], axis=1).reshape(-1)
    keep = g_tiles > 0
    g_first, g_last, g_tile0, g_tiles = (a[keep] for a in (g_first, g_last, g_tile0, g_tiles))
    tile_bytes = (g_last - g_first) * TILE_WORDS * 4
    target = min(MAX_RUN_BYTES, max(TILE_WORDS * 4, 16 * int(vecs.sum()) // RUN_BLOCKS))
    g_per = np.clip(target // np.maximum(tile_bytes, 1), 1, np.maximum(g_tiles, 1))
    group_block = _prefix(-(-g_tiles // g_per))
    lone = g_last - g_first == 1
    lone_words = int((sorted_vecs[g_first[lone]] * 4 - g_tile0[lone] * TILE_WORDS).sum())
    gen = np.flatnonzero(words > w0)
    aligned = (addr[gen] % 4 == 0) & (contiguous[gen] | ((run[gen] % 4 == 0) & (stride[gen] % 4 == 0)))
    mode = np.where(aligned, MODE_WORD, MODE_BYTES).astype(np.int64)
    gen_block = _prefix(-(-(words - w0)[gen] // GENERAL_BLOCK_WORDS))
    table = np.concatenate([
        addr[fast], vecs[fast], row[fast], g_first, g_last, g_tile0, g_tiles, g_per, group_block,
        addr[gen], total[gen], run[gen], stride[gen], w0[gen], words[gen], row[gen], mode, gen_block,
    ]).astype(np.int64)
    return SegmentPlan(
        table=table, n_fast=int(fast.size), n_groups=int(g_first.size), n_general=int(gen.size),
        fast_blocks=int(group_block[-1]), general_blocks=int(gen_block[-1]),
        weight_indices=int(g_tiles[~lone].sum()) * TILE_WORDS, fast_words=int(w0.sum()),
        lone_words=lone_words, general_words=int((words - w0)[gen].sum()),
    )


def _chunk_segments(addr: np.ndarray, total: np.ndarray, chunk: np.ndarray):
    """Every chunk of every tensor as a contiguous segment: (addr, bytes,
    each tensor's first row, each tensor's chunk count); rows run over
    the chunks in order."""
    n_chunks = -(-total // chunk)
    first_row = _prefix(n_chunks)
    leaf = np.repeat(np.arange(total.size), n_chunks)
    start = (np.arange(first_row[-1], dtype=np.int64) - first_row[leaf]) * chunk[leaf]
    return addr[leaf] + start, np.minimum(chunk[leaf], total[leaf] - start), first_row[:-1], n_chunks


def _check_chunk_bytes(chunk_bytes: int) -> None:
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes must be a positive multiple of 4; got {chunk_bytes}")


def _check_cuda(x: torch.Tensor) -> None:
    _check_dtype(x)
    if not x.is_contiguous():
        raise ValueError("the fingerprint kernels take a contiguous tensor")


def _one_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"a fingerprint batch lies on one device; got {sorted(map(str, devices))}")
    return devices.pop()


_batch_fn = None


def _batch_kernel():
    """``xs128_batch`` of the built library."""
    global _batch_fn
    if _batch_fn is None:
        fn = build.load_library("fingerprint").xs128_batch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        _batch_fn = fn
    return _batch_fn


class PreparedBatch:
    """A planned batch bound to its table on the card and a fresh (rows,
    4) output, as the wrappers launch it. ``launch()`` zero-fills the
    output and launches the kernel once on the current stream, returning
    the cudaError_t; it counts nothing, so a caller can time the launch
    alone. ``segments`` is the count of non-empty items."""

    def __init__(self, plan: SegmentPlan, out: torch.Tensor, held: List[torch.Tensor], segments: int):
        self.plan, self.out, self.segments = plan, out, segments
        self._held = held  # the tensors the table points into
        self._fn = _batch_kernel()
        # From pinned memory, on the stream the kernel runs on: the caching
        # host allocator keeps the block until the copy has completed.
        self.table = torch.from_numpy(plan.table).pin_memory().to(out.device, non_blocking=True)

    def launch(self) -> int:
        p = self.plan
        return self._fn(self.table.data_ptr(), p.n_fast, p.n_groups, p.n_general, p.fast_blocks,
                        p.general_blocks, self.out.data_ptr(), self.out.shape[0],
                        torch.cuda.current_stream(self.out.device).cuda_stream)


def prepare_boxes(items: Sequence[Tuple[torch.Tensor, Optional[Sequence[Tuple[int, int]]]]]) -> PreparedBatch:
    """K4 over ``items`` ((contiguous CUDA tensor, box or None) pairs on
    one device), bound to a fresh (len(items), 4) output: row i is item
    i's lanes."""
    device = _one_device([x for x, _ in items])
    addr, total, run, stride = (np.zeros(len(items), dtype=np.int64) for _ in range(4))
    for i, (x, box) in enumerate(items):
        _check_cuda(x)
        if box is None:  # the whole tensor: one run
            addr[i] = x.data_ptr()
            total[i] = run[i] = stride[i] = x.numel() * x.element_size()
            continue
        layout = box_layout(x.shape, x.element_size(), box)
        if layout is None:
            raise ValueError(
                f"box {list(box)} of shape {list(x.shape)} is not runs of one "
                f"length at one stride; fingerprint a contiguous copy of it"
            )
        offset, total[i], run[i], stride[i] = layout
        addr[i] = x.data_ptr() + offset
    plan = plan_segments(addr, total, run, stride, np.arange(len(items)))
    out = torch.empty((len(items), N_LANES), dtype=torch.int32, device=device)
    return PreparedBatch(plan, out, [x for x, _ in items], int(np.count_nonzero(total)))


def _chunk_sizes(n: int, chunk_bytes: Union[int, Sequence[int]]) -> np.ndarray:
    sizes = [chunk_bytes] * n if isinstance(chunk_bytes, int) else list(chunk_bytes)
    if len(sizes) != n:
        raise ValueError(f"{len(sizes)} chunk sizes for {n} tensors")
    for cb in sizes:
        _check_chunk_bytes(cb)
    return np.asarray(sizes, dtype=np.int64)


def prepare_chunked(items: Sequence[torch.Tensor], chunk_bytes: Union[int, Sequence[int]]):
    """K5 over contiguous CUDA tensors on one device (``chunk_bytes`` one
    size, or one a tensor), bound to one output: (batch, each tensor's
    first row, each tensor's chunk count)."""
    device = _one_device(items)
    chunk = _chunk_sizes(len(items), chunk_bytes)
    for x in items:
        _check_cuda(x)
    addr = np.asarray([x.data_ptr() for x in items], dtype=np.int64)
    total = np.asarray([x.numel() * x.element_size() for x in items], dtype=np.int64)
    seg_addr, seg_len, first_row, n_chunks = _chunk_segments(addr, total, chunk)
    plan = plan_segments(seg_addr, seg_len, seg_len, seg_len, np.arange(seg_len.size))
    out = torch.empty((seg_len.size, N_LANES), dtype=torch.int32, device=device)
    return PreparedBatch(plan, out, list(items), int(np.count_nonzero(total))), first_row, n_chunks


def _run(call, out: torch.Tensor, name: str) -> None:
    with torch.cuda.device(out.device):
        err = call()
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def fingerprint_boxes(items: Sequence[Tuple[torch.Tensor, Optional[Sequence[Tuple[int, int]]]]]) -> torch.Tensor:
    """The (len(items), 4) int32 lanes of each ``(x, box)`` (box:
    (start, stop) per dim, or None for all of ``x``), on the items'
    device (one device for the batch), without waiting for it: one
    kernel launch for the batch on a card, the plain version item by
    item on the CPU."""
    global fingerprint_box_launches, fingerprint_box_segments
    items = list(items)
    if not items:
        return torch.empty((0, N_LANES), dtype=torch.int32)
    if _one_device([x for x, _ in items]).type != "cuda":
        return torch.stack([fingerprint_box_reference(x, box) for x, box in items])
    batch = prepare_boxes(items)
    if batch.segments:
        _run(batch.launch, batch.out, "xs128_box")
        fingerprint_box_launches += 1
        fingerprint_box_segments += batch.segments
    else:
        batch.out.zero_()
    return batch.out


def fingerprint_chunked_many(items: Sequence[torch.Tensor], chunk_bytes: Union[int, Sequence[int]]) -> List[torch.Tensor]:
    """The (n_chunks_i, 4) int32 lanes of every ``chunk_bytes`` slice of
    each tensor's payload (one size, or one a tensor), on the tensors'
    device (one device for the batch), without waiting for it: views
    into one output filled by one kernel launch on a card; the plain
    version tensor by tensor on the CPU."""
    global fingerprint_chunked_launches, fingerprint_chunked_segments
    items = list(items)
    if not items:
        return []
    if _one_device(items).type != "cuda":
        sizes = _chunk_sizes(len(items), chunk_bytes)
        return [fingerprint_chunked_reference(x, int(cb)) for x, cb in zip(items, sizes)]
    batch, first_row, n_chunks = prepare_chunked(items, chunk_bytes)
    if batch.segments:
        _run(batch.launch, batch.out, "xs128_chunked")
        fingerprint_chunked_launches += 1
        fingerprint_chunked_segments += batch.segments
    return [batch.out[int(f) : int(f) + int(n)] for f, n in zip(first_row, n_chunks)]


def fingerprint_box(x: torch.Tensor, box: Optional[Sequence[Tuple[int, int]]] = None) -> torch.Tensor:
    """The (4,) int32 lanes of box ``box`` of ``x``: a batch of one."""
    return fingerprint_boxes([(x, box)])[0]


def fingerprint_chunked(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """The (n_chunks, 4) int32 lanes of every ``chunk_bytes`` slice of
    ``x``'s payload: a batch of one."""
    return fingerprint_chunked_many([x], chunk_bytes)[0]
