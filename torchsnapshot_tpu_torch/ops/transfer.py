"""Device↔host transfer ops for CUDA tensors.

- :func:`device_to_host` — D2H of a tensor's payload bytes into a private
  pinned host buffer, on a side stream ordered after the work that
  produced the tensor, issued in ``transfer_chunk_bytes`` pieces. The
  caller gets the buffer only after the copy's event has completed, so a
  checksum or a storage write never reads stale bytes.
- :class:`H2DPipeline` — the restore's host→device engine: a pool of
  ``h2d_depth()`` workers (``TPUSNAPSHOT_H2D_DEPTH``, default 2), each
  copying on its own side stream from a pinned staging buffer into the
  destination and resolving its future once the copy has completed.
  Consumers submit a piece the moment it has verified and go back to
  consuming, so transfers overlap the reads still in flight.
- :func:`device_clone` — HBM→HBM copies of CUDA tensors on their
  device's current stream: the consistent cut of an async take.
- :func:`probe_d2h_gbps` / :func:`probe_h2d_gbps` — the pinned-memory
  ceilings a take and a restore are measured against.

``TPUSNAPSHOT_TRANSFER_CHUNK_BYTES`` (default 64 MiB) sets the chunk of
:func:`device_to_host`; :data:`H2D_CHUNK_BYTES` (16 MiB) is the staging
slot of the restore's pipeline.
"""

import ctypes
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import staging_pool, telemetry, tracing
from ..telemetry import consume_profile as _cprof
from ..telemetry import metrics as _metric_names
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
    without one the copy waits for the device's current stream. Traced
    as a ``d2h`` span, from the copy's enqueue to its completion, with the
    pinned buffer's allocation a ``d2h.pin`` span inside it.
    """
    if not tracing.enabled():
        return _device_to_host(src, ready, traced=False)
    with tracing.span("d2h", bytes=src.numel() * src.element_size()):
        return _device_to_host(src, ready, traced=True)


def _device_to_host(
    src: torch.Tensor, ready: Optional[torch.cuda.Event], traced: bool
) -> torch.Tensor:
    stream = _side_stream(src.device)
    if ready is not None:
        stream.wait_event(ready)
    else:
        stream.wait_stream(torch.cuda.current_stream(src.device))
    step = transfer_chunk_bytes()
    with torch.cuda.stream(stream):
        flat = src.detach().contiguous().reshape(-1).view(torch.uint8)
        t0 = time.monotonic()
        out = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
        if traced:
            tracing.complete("d2h.pin", t0, time.monotonic())
        for lo in range(0, flat.numel(), step):
            out[lo : lo + step].copy_(flat[lo : lo + step], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def host_copy(dst: torch.Tensor, src: Any) -> None:
    """Copy the bytes of buffer (or C-contiguous numpy array) ``src`` into
    the contiguous host tensor ``dst`` of the same byte length.

    ctypes releases the GIL around the memmove. A numpy slice assignment
    holds it for the whole copy, and a restore's sixteen consume threads
    copying payloads that way starve the H2D pipeline's workers, whose
    every CUDA call then waits for the GIL."""
    view = src if isinstance(src, np.ndarray) else np.frombuffer(src, dtype=np.uint8)
    nbytes = dst.numel() * dst.element_size()
    if view.nbytes != nbytes or not dst.is_contiguous() or not view.flags.c_contiguous:
        raise ValueError(
            f"host_copy needs contiguous buffers of one size, got {view.nbytes} "
            f"bytes into {nbytes}"
        )
    if nbytes:
        ctypes.memmove(dst.data_ptr(), view.ctypes.data, nbytes)


# The staging slot a restore sends a contiguous run through to a card,
# piece by piece (the JAX package's default chunk for its host→device
# pieces).
H2D_CHUNK_BYTES = 16 * 1024 * 1024


_H2D_DEPTH_ENV_VAR = "TPUSNAPSHOT_H2D_DEPTH"
_DEFAULT_H2D_DEPTH = 2
_H2D_THREAD_PREFIX = "tpusnapshot-h2d"


def h2d_depth() -> int:
    return max(1, env_int(_H2D_DEPTH_ENV_VAR, _DEFAULT_H2D_DEPTH))


def on_h2d_thread() -> bool:
    """Whether the caller runs on an H2D pipeline worker."""
    return threading.current_thread().name.startswith(_H2D_THREAD_PREFIX)


class H2DPipeline:
    """Depth-limited asynchronous host→device transfer engine.

    Depth 2 is double buffering: one piece's bytes ride the link while
    the next piece's read and verification proceed."""

    def __init__(self, depth: Optional[int] = None) -> None:
        self._pool = ThreadPoolExecutor(
            max_workers=depth if depth is not None else h2d_depth(),
            thread_name_prefix=_H2D_THREAD_PREFIX,
        )

    def submit(
        self,
        src: Any,
        dst: torch.Tensor,
        profile: Optional[_cprof.ConsumeProfile] = None,
        ready: Optional[torch.cuda.Event] = None,
        then: Optional[Callable[[], None]] = None,
        lease: Optional[staging_pool.StagingLease] = None,
    ) -> "Future[None]":
        """Schedule ``dst.copy_(src)``: ``src`` a host tensor (pinned for
        a CUDA ``dst``; for a CPU ``dst`` also a numpy array of its
        bytes), ``dst`` a tensor of the same shape on the target device.
        Returns a future that resolves AFTER the bytes have landed, and
        carries any exception: callers surface it before they publish
        anything.

        For a CUDA ``dst`` the worker copies on its own side stream, after
        ``ready`` (an event recorded after the work that produced or last
        used ``dst``; recorded now on the device's current stream if
        None), then runs ``then`` (more work on that stream: an on-card
        scatter of the landed bytes). The copy is issued blocking: one
        call that queues the DMA and synchronizes the side stream, where
        a non-blocking copy, an event record and its synchronize would be
        three, each giving up and retaking the GIL, which under a
        restore's load costs milliseconds a time. The ``lease`` that
        holds ``src`` is held from now until the copy has completed, so
        the pool never hands the buffer on mid-DMA."""
        nbytes = src.nbytes if isinstance(src, np.ndarray) else src.numel() * src.element_size()
        if dst.is_cuda and ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dst.device))
        if lease is not None:
            lease.hold()

        def _copy() -> None:
            if not dst.is_cuda:
                if not isinstance(src, np.ndarray):
                    dst.copy_(src)
                elif src.flags.c_contiguous and dst.is_contiguous():
                    host_copy(dst, src)
                else:
                    dst.numpy()[...] = src
                if then is not None:
                    then()
                return
            if torch.cuda.current_device() != dst.device.index:
                torch.cuda.set_device(dst.device)
            stream = _side_stream(dst.device)
            with torch.cuda.stream(stream):
                # query() keeps the GIL; wait_event gives it up.
                if not ready.query():
                    stream.wait_event(ready)
                dst.copy_(src)
                if then is not None:
                    then()
                    stream.synchronize()

        def _transfer() -> None:
            try:
                t0 = time.monotonic()
                with _cprof.overlap_span(profile, nbytes):
                    _copy()
                # Host wall time of each call (the profile's overlap
                # seconds above count concurrent workers' union once).
                telemetry.counter(_metric_names.H2D_OVERLAP_SECONDS).inc(
                    time.monotonic() - t0
                )
                telemetry.counter(_metric_names.H2D_OVERLAP_BYTES).inc(nbytes)
            finally:
                if lease is not None:
                    lease.drop()

        try:
            return self._pool.submit(tracing.carry(_transfer))
        except BaseException:
            if lease is not None:
                lease.drop()
            raise


_h2d_pipeline: Optional[H2DPipeline] = None
_h2d_pipeline_lock = threading.Lock()


def h2d_pipeline() -> H2DPipeline:
    """The process-wide H2D pipeline (its depth read once)."""
    global _h2d_pipeline
    with _h2d_pipeline_lock:
        if _h2d_pipeline is None:
            _h2d_pipeline = H2DPipeline()
        return _h2d_pipeline


def _reset_h2d_pipeline_for_tests() -> None:
    global _h2d_pipeline
    with _h2d_pipeline_lock:
        _h2d_pipeline = None


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


# The restore report's H2D anchor: probed once per process, at this size.
_H2D_PROBE_BYTES_ENV_VAR = "TPUSNAPSHOT_H2D_PROBE_BYTES"
_DEFAULT_H2D_PROBE_BYTES = 32 * 1024 * 1024
_report_probe: List[Optional[float]] = []
_report_probe_lock = threading.Lock()


def _chunked_h2d_seconds(nbytes: int, device: torch.device) -> float:
    """Host wall seconds of one restore-style transfer of a fresh pinned
    ``nbytes`` buffer to ``device``: ``H2D_CHUNK_BYTES`` pieces, each a
    blocking copy as the H2D pipeline's workers issue them, on this
    thread's copy stream. The destination is allocated on that stream,
    so the copies wait for no other work on the card, and the only wait
    is each piece's own (a copy stream's synchronize, never the
    device's)."""
    stream = _side_stream(device)
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    src.numpy()[:] = np.random.default_rng(11).integers(0, 256, nbytes, dtype=np.uint8)
    with torch.cuda.stream(stream):
        dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
        begin = time.monotonic()
        for lo in range(0, nbytes, H2D_CHUNK_BYTES):
            dst[lo : lo + H2D_CHUNK_BYTES].copy_(src[lo : lo + H2D_CHUNK_BYTES])
        elapsed = time.monotonic() - begin
        del dst
    return elapsed


def report_h2d_probe_gbps() -> Optional[float]:
    """The host→device rate in GiB/s (2**30 bytes/s, the unit of the
    flight reports) of the restore's own piece-by-piece transfer, best of
    two runs each from a fresh host buffer, measured once per process on
    the current card (the JAX package probes through its chunked put the
    same way); None without a card or with ``TPUSNAPSHOT_H2D_PROBE_BYTES=0``.
    It runs inside a restore's report, so it waits on its own copies and
    nothing else: no device-wide synchronize."""
    with _report_probe_lock:
        if not _report_probe:
            nbytes = env_int(_H2D_PROBE_BYTES_ENV_VAR, _DEFAULT_H2D_PROBE_BYTES)
            result: Optional[float] = None
            if nbytes > 0 and torch.cuda.is_available():
                try:
                    device = torch.device("cuda", torch.cuda.current_device())
                    best = max(
                        nbytes / (1 << 30) / max(_chunked_h2d_seconds(nbytes, device), 1e-9)
                        for _ in range(2)
                    )
                    result = best if best > 0 else None
                # Capability probe: a card that cannot run the probe
                # yields "no probe", never a failed restore report.
                except Exception:  # snapcheck: disable=swallowed-exception -- capability probe
                    result = None
            _report_probe.append(result)
        return _report_probe[0]
