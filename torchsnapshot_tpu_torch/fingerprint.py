"""Content fingerprints for incremental and content-chunked snapshots, in
the JAX package's ``xs128`` format.

The payload (the little-endian C-order bytes a snapshot stores),
zero-padded to a multiple of 4 bytes, is read as u32 words ``w_i``; for
four lanes ``k``::

    F_k = sum_i  w_i * mix(i * GOLD + k * SALT + 1)   (mod 2^32)

with ``mix`` the murmur3 finalizer. A fingerprint is
``"xs128:<32 hex>"``. The word view is defined on the stored bytes, so a
fingerprint computed on the card (:func:`fingerprint_device_many_async`,
one launch of the kernels of ``ops/fingerprint.py`` for a whole batch),
by their plain versions on the CPU, or on the host
(:func:`fingerprint_host`) agree bit for bit for every dtype, and equal the JAX package's (whose device path equals its host
path on the CPU). Complex payloads have no word view and raise; callers
then write the leaf in full, unfingerprinted, as the JAX package does.

A fingerprint gates deduplication of a process's own state: it is not a
defence against an adversary. A mismatch only ever costs a full write.
"""

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .ops import fingerprint as _ops

FINGERPRINT_ALGO = "xs128"

_GOLD = np.uint32(_ops.GOLD)
_SALT = np.uint32(_ops.SALT)
_N_LANES = _ops.N_LANES
_M1 = np.uint32(_ops.M1)
_M2 = np.uint32(_ops.M2)

_HOST_CHUNK_WORDS = 1 << 22  # 16 MiB a pass


def format_fingerprint(lanes: Any) -> str:
    """``"xs128:<32 hex>"`` from four u32 lane values."""
    vals = np.asarray(lanes).astype(np.int64)
    return FINGERPRINT_ALGO + ":" + "".join(f"{int(v) & 0xFFFFFFFF:08x}" for v in vals)


# ------------------------------------------------------------------- device


def _static_box(x: torch.Tensor, slices: Optional[Sequence[slice]]) -> Optional[List[Tuple[int, int]]]:
    if slices is None:
        return None
    return [
        (0 if s.start is None else int(s.start), int(x.shape[d]) if s.stop is None else int(s.stop))
        for d, s in enumerate(slices)
    ]


def _box_item(x: torch.Tensor, slices: Optional[Sequence[slice]]) -> Tuple[torch.Tensor, Optional[List[Tuple[int, int]]]]:
    """``(x, box)`` as K4 reads it: a box cut along one dimension is read
    in place, as runs; a non-contiguous tensor, or a box of another
    shape, is first copied on its device."""
    _ops._check_dtype(x)
    box = _static_box(x, slices)
    if not x.is_contiguous() or (
        box is not None and _ops.box_layout(x.shape, x.element_size(), box) is None
    ):
        if box is not None:
            x = x[tuple(slice(a, b) for a, b in box)]
            box = None
        x = x.contiguous()
    return x, box


def _by_device(tensors: Sequence[torch.Tensor]) -> Dict[torch.device, List[int]]:
    groups: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


# Bytes of copies (of non-contiguous tensors, and of boxes that are not
# runs) a batch holds on a device until its launch. A copy that would
# pass it first launches what the device's batch holds so far, which
# releases its copies: a batch holds at most this plus one copy, never a
# second copy of a whole state, and leaves read in place still share one
# launch.
COPY_BYTES_PER_LAUNCH = 256 << 20


def _batched(items: Sequence[Tuple[Any, Any]], prepare, launch) -> List[Any]:
    """``launch`` over ``items`` prepared one by one (``prepare(item)``
    -> (tensor, arg), the tensor a copy when it lies in another storage
    than the item's), one batch per device, the batch launched early
    where its copies would pass ``COPY_BYTES_PER_LAUNCH``."""
    out: List[Any] = [None] * len(items)
    pending: Dict[torch.device, List[Tuple[int, torch.Tensor, Any]]] = {}
    held: Dict[torch.device, int] = {}

    def flush(device: torch.device) -> None:
        batch = pending.pop(device, [])
        held[device] = 0
        if batch:
            for (i, _, _), r in zip(batch, launch([(t, arg) for _, t, arg in batch])):
                out[i] = r

    for i, item in enumerate(items):
        t, arg = prepare(item)
        device = t.device
        if t.numel() and t.untyped_storage().data_ptr() != item[0].untyped_storage().data_ptr():
            nbytes = t.numel() * t.element_size()
            if held.get(device, 0) and held[device] + nbytes > COPY_BYTES_PER_LAUNCH:
                flush(device)
            held[device] = held.get(device, 0) + nbytes
        pending.setdefault(device, []).append((i, t, arg))
    for device in list(pending):
        flush(device)
    return out


def fingerprint_device_many_async(items: Sequence[Tuple[torch.Tensor, Optional[Sequence[slice]]]]) -> List[torch.Tensor]:
    """Dispatch the fingerprints of ``items`` (``(tensor, slices)``,
    slices None for the whole tensor) and return their (4,) int32 results
    without waiting; resolve with :func:`resolve_fingerprints`. On a card
    the batch is one K4 launch per device (more where copies pass
    ``COPY_BYTES_PER_LAUNCH``)."""
    return _batched(list(items), lambda item: _box_item(*item), lambda batch: list(_ops.fingerprint_boxes(batch)))


def fingerprint_device_async(x: torch.Tensor, slices: Optional[Sequence[slice]] = None) -> torch.Tensor:
    """:func:`fingerprint_device_many_async` of one tensor (or of its
    sub-box ``slices``): its (4,) int32 result, without waiting."""
    return fingerprint_device_many_async([(x, slices)])[0]


def fingerprint_device_chunked_many_async(items: Sequence[torch.Tensor], chunk_bytes: Union[int, Sequence[int]]) -> List[torch.Tensor]:
    """Dispatch per-chunk fingerprints over each tensor's payload,
    ``chunk_bytes`` (a positive multiple of 4; one size, or one a tensor)
    a chunk, and return the (n_chunks, 4) int32 results without waiting;
    resolve with :func:`resolve_chunk_fingerprints`. On a card the batch
    is one K5 launch per device (more where copies of non-contiguous
    tensors pass ``COPY_BYTES_PER_LAUNCH``)."""
    items = list(items)
    sizes = [int(cb) for cb in _ops._chunk_sizes(len(items), chunk_bytes)]
    for x in items:
        _ops._check_dtype(x)

    def launch(batch):
        return _ops.fingerprint_chunked_many([x for x, _ in batch], [cb for _, cb in batch])

    return _batched(list(zip(items, sizes)), lambda item: (item[0].contiguous(), item[1]), launch)


def fingerprint_device_chunked_async(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """:func:`fingerprint_device_chunked_many_async` of one tensor: its
    (n_chunks, 4) int32 result, without waiting."""
    return fingerprint_device_chunked_many_async([x], chunk_bytes)[0]


def _fetch_by_device(results: List[torch.Tensor]) -> Dict[int, np.ndarray]:
    """Each result as a u32 numpy array, fetched with one device→host copy
    per device (every 16-byte fetch alone would pay a link round trip)."""
    out: Dict[int, np.ndarray] = {}
    for idxs in _by_device(results).values():
        flat = torch.cat([results[i].reshape(-1) for i in idxs]).cpu().numpy().view(np.uint32)
        pos = 0
        for i in idxs:
            n = results[i].numel()
            out[i] = flat[pos : pos + n].reshape(results[i].shape)
            pos += n
    return out


def resolve_fingerprints(results: List[Any]) -> List[Any]:
    """Fingerprint strings of a batch of :func:`fingerprint_device_async`
    results, with one device→host copy per device; an item that fails
    resolves to its ``Exception``."""
    try:
        fetched = _fetch_by_device(results)
    except Exception:  # resolve item by item, keeping each one's error
        fetched = None
    out: List[Any] = []
    for i, r in enumerate(results):
        try:
            lanes = fetched[i] if fetched is not None else r.cpu().numpy().view(np.uint32)
            out.append(format_fingerprint(lanes))
        except Exception as e:
            out.append(e)
    return out


def resolve_chunk_fingerprints(results: List[Any]) -> List[Any]:
    """Per-chunk fingerprint lists of a batch of
    :func:`fingerprint_device_chunked_async` results (one device→host
    copy per device); an item that fails resolves to its ``Exception``."""
    try:
        fetched = _fetch_by_device(results)
    except Exception:
        fetched = None
    out: List[Any] = []
    for i, r in enumerate(results):
        try:
            rows = fetched[i] if fetched is not None else r.cpu().numpy().view(np.uint32)
            out.append([format_fingerprint(row) for row in rows])
        except Exception as e:
            out.append(e)
    return out


# --------------------------------------------------------------------- host


def _mix_u32_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * _M1
    h = h ^ (h >> np.uint32(13))
    h = h * _M2
    h = h ^ (h >> np.uint32(16))
    return h


def _host_bytes(data: Any) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        data = _ops.flat_bytes(data.detach().cpu()).numpy()
    if isinstance(data, np.ndarray):
        if data.dtype == np.bool_:
            data = data.astype(np.uint8)
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def _weights_np(start: int, n: int) -> List[np.ndarray]:
    """The four lanes' weights of word indices [start, start + n)."""
    i = np.arange(start, start + n, dtype=np.uint32)
    return [
        _mix_u32_np(i * _GOLD + np.uint32((int(_SALT) * k + 1) & 0xFFFFFFFF))
        for k in range(_N_LANES)
    ]


_CACHED_WEIGHT_WORDS = 1 << 20  # the 4 MiB default chunk: 16 MB of weights


@functools.lru_cache(maxsize=2)
def _pow2_weights_np(n: int) -> List[np.ndarray]:
    return _weights_np(0, n)


def _first_weights_np(n: int) -> List[np.ndarray]:
    """Weights of indices [0, n). Every content chunk a restore verifies
    starts at index 0, so up to the default chunk's length they are
    computed once, for the next power of two, and sliced."""
    if n > _CACHED_WEIGHT_WORDS:
        return _weights_np(0, n)
    full = _pow2_weights_np(max(1024, 1 << max(0, n - 1).bit_length()))
    return [m[:n] for m in full]


def fingerprint_host(data: Any) -> str:
    """Fingerprint host bytes, a numpy array or a CPU tensor (over its
    C-order little-endian bytes), in numpy."""
    buf = _host_bytes(data)
    n_pad = (-buf.shape[0]) % 4
    if n_pad:
        buf = np.concatenate([buf, np.zeros((n_pad,), dtype=np.uint8)])
    words = buf.view(np.uint32)
    lanes = np.zeros((_N_LANES,), dtype=np.uint32)
    # In passes, so a large payload never makes a weight array its size.
    for start in range(0, words.shape[0], _HOST_CHUNK_WORDS):
        w = words[start : start + _HOST_CHUNK_WORDS]
        ms = _first_weights_np(w.shape[0]) if start == 0 else _weights_np(start, w.shape[0])
        for k in range(_N_LANES):
            lanes[k] = (int(lanes[k]) + int(np.sum(w * ms[k], dtype=np.uint32))) & 0xFFFFFFFF
    return format_fingerprint(lanes)


def fingerprint_host_chunked(data: Any, chunk_bytes: int) -> List[str]:
    """Per-chunk fingerprints of host bytes, a numpy array or a CPU
    tensor: :func:`fingerprint_host` of each ``chunk_bytes`` slice of the
    payload. Rows go in passes of at most ``_HOST_CHUNK_WORDS`` words and
    only the tail chunk is copied, so memory stays bounded."""
    _ops._check_chunk_bytes(chunk_bytes)
    buf = _host_bytes(data)
    n = buf.shape[0]
    chunk_words = chunk_bytes // 4
    n_full = n // chunk_bytes
    n_chunks = -(-n // chunk_bytes) if n else 0
    ms = _first_weights_np(chunk_words)
    out = np.zeros((n_chunks, _N_LANES), dtype=np.uint32)
    body = buf[: n_full * chunk_bytes].view(np.uint32)
    batch_rows = max(1, _HOST_CHUNK_WORDS // chunk_words)
    for start in range(0, n_full, batch_rows):
        stop = min(n_full, start + batch_rows)
        rows = body[start * chunk_words : stop * chunk_words].reshape(stop - start, chunk_words)
        for k in range(_N_LANES):
            out[start:stop, k] = np.sum(rows * ms[k][None, :], axis=1, dtype=np.uint32)
    if n_chunks > n_full:
        padded = np.zeros((chunk_bytes,), dtype=np.uint8)
        tail = buf[n_full * chunk_bytes :]
        padded[: tail.shape[0]] = tail
        words = padded.view(np.uint32)
        for k in range(_N_LANES):
            out[n_full, k] = np.sum(words * ms[k], dtype=np.uint32)
    return [format_fingerprint(row) for row in out]
