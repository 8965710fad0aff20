"""Device↔host transfer ops for CUDA tensors.

- :func:`device_to_host` — D2H of a tensor's payload bytes into a private
  pinned host buffer, on a side stream ordered after the work that
  produced the tensor, issued in ``transfer_chunk_bytes`` pieces. The
  caller gets the buffer only after the copy's event has completed, so a
  checksum or a storage write never reads stale bytes.
- :func:`host_to_device` — H2D of payload bytes into a CUDA tensor through
  two pinned bounce buffers: the host copy of one chunk into pinned
  memory overlaps the non-blocking DMA of the previous chunk, each buffer
  reused only after its event completed.
- :func:`device_clone` — HBM→HBM copies of CUDA tensors on their
  device's current stream: the consistent cut of an async take.
- :func:`probe_d2h_gbps` / :func:`probe_h2d_gbps` — the pinned-memory
  ceilings a take and a restore are measured against.

``TPUSNAPSHOT_TRANSFER_CHUNK_BYTES`` (default 64 MiB) sets the chunk.
"""

import threading
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..utils.env import env_int

_DEFAULT_TRANSFER_CHUNK_BYTES = 64 * 1024 * 1024

_streams = threading.local()


def transfer_chunk_bytes() -> int:
    return max(1, env_int("TPUSNAPSHOT_TRANSFER_CHUNK_BYTES", _DEFAULT_TRANSFER_CHUNK_BYTES))


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One copy stream per (thread, device): concurrent staging threads
    get independent DMA queues."""
    cache = getattr(_streams, "by_device", None)
    if cache is None:
        cache = _streams.by_device = {}
    stream = cache.get(device.index)
    if stream is None:
        stream = cache[device.index] = torch.cuda.Stream(device=device)
    return stream


def device_to_host(
    src: torch.Tensor, ready: Optional[torch.cuda.Event] = None
) -> torch.Tensor:
    """Copy the C-order bytes of CUDA tensor ``src`` into a new pinned
    uint8 host tensor and return it once the copy has completed.

    ``ready`` is an event recorded after the work that produced ``src``;
    without one the copy waits for the device's current stream.
    """
    stream = _side_stream(src.device)
    if ready is not None:
        stream.wait_event(ready)
    else:
        stream.wait_stream(torch.cuda.current_stream(src.device))
    step = transfer_chunk_bytes()
    with torch.cuda.stream(stream):
        flat = src.detach().contiguous().reshape(-1).view(torch.uint8)
        out = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
        for lo in range(0, flat.numel(), step):
            out[lo : lo + step].copy_(flat[lo : lo + step], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def host_to_device(src: Any, dst: torch.Tensor) -> None:
    """Copy payload bytes ``src`` (any buffer) into the contiguous CUDA
    tensor ``dst`` and return once they have landed."""
    if not dst.is_contiguous():
        raise ValueError("host_to_device needs a contiguous destination")
    data = np.frombuffer(src, dtype=np.uint8)
    dst_bytes = dst.reshape(-1).view(torch.uint8)
    if data.size != dst_bytes.numel():
        raise ValueError(
            f"payload of {data.size} bytes does not fit a tensor of "
            f"{dst_bytes.numel()} bytes"
        )
    if data.size == 0:
        return
    step = min(transfer_chunk_bytes(), data.size)
    stream = _side_stream(dst.device)
    # The destination may still be in use by work queued on the device's
    # current stream (a forward pass reading the weights being replaced).
    stream.wait_stream(torch.cuda.current_stream(dst.device))
    bounce = [torch.empty(step, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    events = [None, None]
    with torch.cuda.stream(stream):
        for i, lo in enumerate(range(0, data.size, step)):
            hi = min(lo + step, data.size)
            slot = i % 2
            if events[slot] is not None:
                events[slot].synchronize()
            buf = bounce[slot][: hi - lo]
            buf.numpy()[:] = data[lo:hi]
            dst_bytes[lo:hi].copy_(buf, non_blocking=True)
            events[slot] = torch.cuda.Event()
            events[slot].record(stream)
    for ev in events:
        if ev is not None:
            ev.synchronize()


def is_oom_error(exc: BaseException) -> bool:
    return isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError))


def device_clone(tensors: Sequence[torch.Tensor]) -> Optional[List[torch.Tensor]]:
    """Private copies of CUDA ``tensors``, enqueued on each device's
    current stream: work the caller queues there afterwards (the next
    training step's in-place update) is ordered after the copies, so the
    clones hold the values as of this call with no synchronisation.
    Returns None, with the partial clones released, if the card ran out
    of memory."""
    clones: List[torch.Tensor] = []
    try:
        for tensor in tensors:
            clones.append(tensor.detach().clone())
    except Exception as e:
        if is_oom_error(e):
            clones.clear()
            return None
        raise
    return clones


def _best_gbps(nbytes: int, run) -> float:
    best = 0.0
    for _ in range(3):
        begin = time.perf_counter()
        run()
        elapsed = time.perf_counter() - begin
        best = max(best, nbytes / 1e9 / elapsed)
    return best


def probe_d2h_gbps(nbytes: int, device: Any = "cuda") -> float:
    """Pinned device→host copy rate in GB/s (1e9 bytes/s): one
    ``nbytes`` copy into a preallocated pinned buffer, best of three."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    torch.cuda.synchronize(src.device)

    def run() -> None:
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(src.device)

    return _best_gbps(nbytes, run)


def probe_h2d_gbps(nbytes: int, device: Any = "cuda") -> float:
    """Pinned host→device copy rate in GB/s (1e9 bytes/s): one ``nbytes``
    copy from a preallocated pinned buffer, best of three."""
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    torch.cuda.synchronize(dst.device)

    def run() -> None:
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(dst.device)

    return _best_gbps(nbytes, run)
