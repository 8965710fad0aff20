"""xs128 content fingerprints: the hand-written CUDA kernels K4 and K5
and their plain versions.

``fingerprint_box(x, box)`` computes the four u32 lanes of one tensor's
payload (or of the sub-box ``box`` of it); ``fingerprint_chunked(x,
chunk_bytes)`` computes them for every ``chunk_bytes`` slice of the
payload, indices restarting at each chunk. The payload is the tensor's
stored bytes read as little-endian u32 words, the tail zero-padded, so
the result depends on the bytes alone, whatever the dtype. On a CUDA
tensor the wrappers launch ``csrc/fingerprint.cu`` (the Hopper ports of
the JAX package's XLA-jitted ``_fingerprint_device_jit`` and
``_fingerprint_device_chunked_jit``, ``torchsnapshot_tpu/fingerprint.py``
:123 and :219); on a CPU tensor they compute the plain versions. There
is no fallback to the plain versions for a CUDA tensor.

Results are int32 tensors holding the u32 bits ((4,) and (n_chunks, 4)),
on the input's device: torch's uint32 is partial, and the caller stacks
and copies them to the host in one transfer.

The plain versions use int64 masked to 32 bits (torch cannot build u32
ranges on the CPU), multiplying in 16-bit halves so that no product
passes 2⁶³, over bounded batches of the payload: a large leaf never
makes an intermediate of its own size.

``fingerprint_box_launches`` and ``fingerprint_chunked_launches`` count
kernel launches, never plain calls.
"""

import ctypes
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch

from . import build

# Kernel launches by the CUDA wrappers in this process.
fingerprint_box_launches = 0
fingerprint_chunked_launches = 0

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


def _check_chunk_bytes(chunk_bytes: int) -> None:
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes must be a positive multiple of 4; got {chunk_bytes}")


def _kernel(name: str, n_ll: int):
    fn = getattr(build.load_library("fingerprint"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * n_ll + [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _check_cuda(x: torch.Tensor) -> None:
    _check_dtype(x)
    if not x.is_contiguous():
        raise ValueError("the fingerprint kernels take a contiguous tensor")


def box_kernel_call(x: torch.Tensor, box: Optional[Sequence[Tuple[int, int]]] = None):
    """K4 bound to CUDA tensor ``x`` and a fresh output, as
    :func:`fingerprint_box` launches it: (call, out, nbytes). The call
    returns the launch's cudaError_t and counts nothing."""
    _check_cuda(x)
    layout = box_layout(x.shape, x.element_size(), box)
    if layout is None:
        raise ValueError(
            f"box {list(box)} of shape {list(x.shape)} is not runs of one "
            f"length at one stride; fingerprint a contiguous copy of it"
        )
    offset, total, run, stride = layout
    out = torch.empty(N_LANES, dtype=torch.int32, device=x.device)
    fn = _kernel("xs128_box", 3)
    args = (x.data_ptr() + offset, total, run, stride, out.data_ptr())

    def call(held=x):
        return fn(*args, torch.cuda.current_stream(out.device).cuda_stream)

    return call, out, total


def chunked_kernel_call(x: torch.Tensor, chunk_bytes: int):
    """K5 bound to CUDA tensor ``x`` and a fresh output: (call, out, nbytes)."""
    _check_cuda(x)
    _check_chunk_bytes(chunk_bytes)
    total = x.numel() * x.element_size()
    out = torch.empty((-(-total // chunk_bytes), N_LANES), dtype=torch.int32, device=x.device)
    fn = _kernel("xs128_chunked", 2)
    args = (x.data_ptr(), total, chunk_bytes, out.data_ptr())

    def call(held=x):
        return fn(*args, torch.cuda.current_stream(out.device).cuda_stream)

    return call, out, total


def _run(call, out: torch.Tensor, name: str) -> None:
    with torch.cuda.device(out.device):
        err = call()
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def fingerprint_box(x: torch.Tensor, box: Optional[Sequence[Tuple[int, int]]] = None) -> torch.Tensor:
    """The (4,) int32 lanes of box ``box`` ((start, stop) per dim; None:
    all) of ``x``, on ``x``'s device, without waiting for the device."""
    global fingerprint_box_launches
    if not x.is_cuda:
        return fingerprint_box_reference(x, box)
    call, out, total = box_kernel_call(x, box)
    _run(call, out, "xs128_box")
    if total:
        fingerprint_box_launches += 1
    return out


def fingerprint_chunked(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """The (n_chunks, 4) int32 lanes of every ``chunk_bytes`` slice of
    ``x``'s payload, on ``x``'s device, without waiting for the device."""
    global fingerprint_chunked_launches
    if not x.is_cuda:
        return fingerprint_chunked_reference(x, chunk_bytes)
    call, out, total = chunked_kernel_call(x, chunk_bytes)
    _run(call, out, "xs128_chunked")
    if total:
        fingerprint_chunked_launches += 1
    return out
