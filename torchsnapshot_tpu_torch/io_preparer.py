"""IO preparers: map values ⇄ manifest entries + write/read requests.

Four value classes, as in the JAX package:

- **sharded arrays** (a ``DTensor`` with a ``Shard`` placement, the
  counterpart of a mesh-sharded ``jax.Array``) → ``ShardedArrayEntry``
  whose shards are the local boxes, stored at
  ``sharded/<path>_<offsets>``; of the ranks holding one box, only the
  one at coordinate 0 on every ``Replicate`` mesh dim writes it;
- **dense arrays** (``torch.Tensor`` on the CPU or a CUDA device, a
  ``DTensor`` replicated on every mesh dim, or ``numpy.ndarray``) →
  ``ArrayEntry`` + one write of raw payload bytes; above
  ``MAX_CHUNK_SIZE_BYTES`` a chunked ``ShardedArrayEntry`` whose chunks
  are separate storage objects, split exactly as the JAX package splits
  them;
- **small scalars** → ``PrimitiveEntry``, inline in the manifest;
- **objects** (anything else picklable) → ``ObjectEntry``.

Staging copies a tensor's bytes (a DTensor's local shard) into a private
host buffer (pinned, for a CUDA tensor) — tensors are mutable, so the
payload must be a cut of the value at take time.

Restore routes every array entry through an :class:`ArrayRestorePlan`
that fills one target box: the whole array for a tensor template, the
local box for a DTensor template. It reads only the stored objects that
overlap the box, and of each only the byte range the box needs where
that range is one run of the object. Objects above the parallel-read
threshold (``TPUSNAPSHOT_PARALLEL_READ_THRESHOLD``, default 64 MiB) are
read as concurrent sub-ranges: streamed to the device as they land when
the object is one run of the box, else assembled in a pooled buffer.
Every byte reaches the box through the H2D pipeline
(``ops/transfer.py``), staged in pinned pooled buffers for a CUDA
target. Publishing is leaf-atomic: a leaf of one verified whole-object
read that reaches the target in one transfer (on a card: at most one
staging slot, ``transfer.H2D_CHUNK_BYTES``) lands in the template tensor
itself; any other leaf lands in a private buffer on the target's
device, charged to the device budget, and is copied into the template
(one on-device ``copy_``) only after every byte has verified and
landed. A failed restore leaves the template's old values. When the
template's dtype, shape or layout differ from the stored box, the
private buffer is the result.
``TPUSNAPSHOT_STRICT_INTEGRITY=1`` reads whole objects where a ranged
read (which no stored checksum covers) would do.

Three kinds of stored object read otherwise, as the JAX package reads
them. A compressed object (``compression="zlib"``) is read whole, its
checksum verified, then decompressed; it is never split or streamed. An
entry borrowed from a base snapshot (``base``, its location decorated
``@base<N>/…``) reads through the snapshot's ``RefRouterPlugin``. A
content-chunked entry (``chunks``) reads one request per content chunk
from the run's chunk store; each chunk is decoded and content-verified
(``chunkstore.decode_and_verify_chunk``) and goes to the leaf's private
buffer at its offset as it lands (when the object is one run of the box;
otherwise the chunks assemble in a pooled buffer and the whole payload
is placed); the leaf publishes once every chunk has verified and landed.
When the box needs only part of a chunk-stored object (a resharded
restore), only the chunks that overlap the byte hull of its slices are
read (chunk pushdown, ``snapserve.pushdown``); the rest of the assembly
buffer is never read. ``TPUSNAPSHOT_CHUNK_PUSHDOWN=0`` and strict
integrity read every chunk.
"""

import asyncio
import os
import threading
from concurrent.futures import Executor, Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import staging_pool, tracing
from .io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from .manifest import (
    ArrayEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    Shard,
    ShardedArrayEntry,
)
from .ops import transfer
from .ops.transfer import (
    device_clone,
    device_to_host,
    h2d_pipeline,
    host_copy,
    on_h2d_thread,
)
from .resharding import compute_overlap, contiguous_byte_range, shard_box, subdivide
from .serialization import (
    ARRAY_SERIALIZER,
    OBJECT_SERIALIZER,
    bytes_to_object,
    compress_payload,
    compute_checksum,
    decompress_payload,
    dtype_itemsize,
    dtype_to_str,
    object_to_bytes,
    str_to_torch_dtype,
    StreamingCrc32,
    tensor_bytes,
    verify_checksum,
)
from . import telemetry
from .telemetry import consume_profile as _cprof
from .telemetry import metrics as _metric_names
from .utils.env import env_int

# Dense arrays above this size are stored as several chunk objects.
MAX_CHUNK_SIZE_BYTES: int = 512 * 1024 * 1024

# Reads of more than this many bytes are split into concurrent ranged
# sub-reads of this size (a single stream caps a large object's read).
_PARALLEL_READ_THRESHOLD_ENV_VAR = "TPUSNAPSHOT_PARALLEL_READ_THRESHOLD"
_DEFAULT_PARALLEL_READ_THRESHOLD = 64 * 1024 * 1024
_STRICT_INTEGRITY_ENV_VAR = "TPUSNAPSHOT_STRICT_INTEGRITY"
_DEVICE_BUDGET_ENV_VAR = "TPUSNAPSHOT_DEVICE_BUDGET_BYTES"
_MIN_DEVICE_BUDGET_BYTES = 256 * 1024 * 1024


def _parallel_read_threshold() -> int:
    return max(1, env_int(_PARALLEL_READ_THRESHOLD_ENV_VAR, _DEFAULT_PARALLEL_READ_THRESHOLD))


def get_device_restore_budget_bytes(device: Optional[torch.device]) -> Optional[int]:
    """Device bytes a restore onto ``device`` may hold in flight (private
    landing buffers awaiting publication): 0.9 × the card's free memory,
    at least 256 MiB. An explicit ``TPUSNAPSHOT_DEVICE_BUDGET_BYTES``
    wins, 0 meaning unbounded; a malformed value falls through to the
    probe (mapping it to unbounded would drop the protection the operator
    asked for). A CPU target has no device budget (None)."""
    if device is None or device.type != "cuda":
        return None
    if os.environ.get(_DEVICE_BUDGET_ENV_VAR) is not None:
        value = env_int(_DEVICE_BUDGET_ENV_VAR, -1)
        if value > 0:
            return value
        if value == 0:
            return None
    free, _total = torch.cuda.mem_get_info(device)
    # Blocks the caching allocator holds but no tensor uses are free to
    # this process too; the CUDA driver counts them as used.
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(int(0.9 * (free + cached)), _MIN_DEVICE_BUDGET_BYTES)

_PRIMITIVE_TYPES = (int, float, bool, str, complex, type(None))


def get_storage_path(rank: int, logical_path: str, replicated: bool) -> str:
    if replicated:
        return f"replicated/{logical_path}"
    return f"{rank}/{logical_path}"


def chunk_location(logical_path: str, offsets: List[int]) -> str:
    suffix = "_".join(str(o) for o in offsets)
    return f"sharded/{logical_path}_{suffix}" if suffix else f"sharded/{logical_path}_0"


def is_dtensor(obj: Any) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return False
    return isinstance(obj, DTensor)


def is_partitioned(obj: Any) -> bool:
    """A DTensor whose data is split (or pending a reduction) across its
    mesh; one replicated on every mesh dim is a dense array."""
    if not is_dtensor(obj):
        return False
    from torch.distributed.tensor import Replicate

    return not all(isinstance(p, Replicate) for p in obj.placements)


def dtensor_box(dt: Any) -> Optional[Tuple[List[int], List[int]]]:
    """(offsets, sizes) of this rank's local shard of ``dt`` in the
    global array; None where this rank is not in its mesh."""
    coordinate = dt.device_mesh.get_coordinate()
    if coordinate is None:
        return None
    return shard_box(list(dt.shape), list(dt.device_mesh.shape), coordinate, dt.placements)


def _nbytes(sizes: List[int], itemsize: int) -> int:
    n = itemsize
    for s in sizes:
        n *= s
    return n


async def _in_executor(executor: Optional[Executor], fn: Callable[[], Any]) -> Any:
    """``fn()`` on ``executor`` (inline without one), under the caller's
    trace id and innermost span: an executor thread carries no context."""
    if executor is None:
        return fn()
    return await asyncio.get_running_loop().run_in_executor(executor, tracing.carry(fn))


class ArrayBufferStager(BufferStager):
    """Stages a tensor or numpy array (or the sub-box ``chunk_slices`` of
    one) into raw payload bytes, compressed when ``compression`` is set,
    and records their checksum (and the compression) in ``entry``."""

    def __init__(
        self,
        data: Any,
        entry: ArrayEntry,
        chunk_slices: Optional[Tuple[slice, ...]] = None,
        compression: Optional[str] = None,
    ) -> None:
        self._data = data
        self._entry = entry
        self._chunk_slices = chunk_slices
        self._compression = compression
        self._nbytes = _nbytes(entry.shape, dtype_itemsize(entry.dtype))
        self._ready = None
        if isinstance(data, torch.Tensor) and data.is_cuda:
            # The D2H runs later on a staging thread's side stream; this
            # event pins it after the work the caller has queued so far.
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(data.device))

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        return await _in_executor(executor, self._stage_sync)

    def _stage_sync(self) -> BufferType:
        data = self._data
        if self._chunk_slices is not None:
            data = data[self._chunk_slices]
        if isinstance(data, torch.Tensor):
            if data.is_cuda:
                host = device_to_host(data, self._ready)
            else:
                host = tensor_bytes(data).clone()
            payload = memoryview(host.numpy())
        else:
            host = np.array(data, copy=True, order="C")
            payload = memoryview(host.reshape(-1).view(np.uint8))
        self._data = None
        if self._compression is not None:
            payload = compress_payload(payload, self._compression)
            self._entry.compression = self._compression
        self._entry.checksum = compute_checksum(payload)
        return payload

    def get_staging_cost_bytes(self) -> int:
        return self._nbytes


def device_clone_write_reqs(write_reqs: List[WriteReq]) -> bool:
    """Rebind every array stager to a private copy of its data: the
    consistent cut of a device-staged async take.

    CUDA tensors are cloned on the card (:func:`device_clone`) and each
    stager's D2H is pinned after the clones by an event on the stream
    that ran them; host tensors and numpy arrays are copied on the host.
    Each source is copied once, however many chunk stagers share it. A
    stager holds its clone until its D2H has completed, so the caching
    allocator cannot hand the clone's memory to later work before then.
    Returns False, with the device clones released, if they did not fit
    on the card (the host copies are kept: host staging reads them).
    """
    sources: Dict[int, torch.Tensor] = {}
    rebinds: List[Tuple[ArrayBufferStager, int]] = []
    host_copies: Dict[int, Any] = {}
    for wr in write_reqs:
        stager = wr.buffer_stager
        if not isinstance(stager, ArrayBufferStager) or stager._data is None:
            continue
        data = stager._data
        key = id(data)
        if isinstance(data, torch.Tensor) and data.is_cuda:
            sources.setdefault(key, data)
            rebinds.append((stager, key))
            continue
        if key not in host_copies:
            host_copies[key] = (
                data.clone() if isinstance(data, torch.Tensor) else np.array(data, copy=True)
            )
        stager._data = host_copies[key]
    order = list(sources)
    nbytes = sum(sources[k].numel() * sources[k].element_size() for k in order)
    with tracing.span("clone", leaves=len(order), bytes=nbytes) as end:
        clones = device_clone([sources[k] for k in order])
        if end is not None:
            end["fell_back"] = clones is None
    if clones is None:
        return False
    clone_by_key = dict(zip(order, clones))
    ready: Dict[torch.device, torch.cuda.Event] = {}
    for stager, key in rebinds:
        clone = clone_by_key[key]
        if clone.device not in ready:
            ready[clone.device] = torch.cuda.Event()
            ready[clone.device].record(torch.cuda.current_stream(clone.device))
        stager._data = clone
        stager._ready = ready[clone.device]
    return True


class ObjectBufferStager(BufferStager):
    """Pickles an object at once (the staging cost is then exact);
    compression and checksum wait for staging, which the non-owner ranks
    of a replicated object never reach."""

    def __init__(self, obj: Any, entry: ObjectEntry, compression: Optional[str] = None) -> None:
        self._buf = object_to_bytes(obj)
        self._entry = entry
        self._compression = compression
        self._staged = False

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        if not self._staged:
            self._staged = True
            if self._compression is not None:
                self._buf = compress_payload(self._buf, self._compression)
                self._entry.compression = self._compression
            self._entry.checksum = compute_checksum(self._buf)
        return self._buf

    def get_staging_cost_bytes(self) -> int:
        return len(self._buf)


class ObjectBufferConsumer(BufferConsumer):
    """Verifies, decompresses and unpickles an object and hands it back
    via callback."""

    def __init__(
        self,
        callback: Callable[[Any], None],
        checksum: Optional[str],
        compression: Optional[str] = None,
    ) -> None:
        self._callback = callback
        self._checksum = checksum
        self._compression = compression
        self._profile = _cprof.current()

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        with _cprof.consume_section():
            with _cprof.substep(self._profile, "verify", len(buf)):
                verify_checksum(buf, self._checksum)
            if self._compression is not None:
                with _cprof.substep(self._profile, "decode", len(buf)):
                    buf = decompress_payload(buf, self._compression)
            with _cprof.substep(self._profile, "deserialize", len(buf)):
                obj = bytes_to_object(buf)
        self._callback(obj)

    def get_consuming_cost_bytes(self) -> int:
        return 1 << 20


class _TargetRegion:
    """The box a plan fills, on the target's device.

    A leaf that arrives in ONE verified whole-object read and reaches
    the target in ONE transfer lands straight in the template's own
    tensor (``direct``): its bytes are checked before any of them is
    written, and a transfer that fails writes none of them. Any other
    leaf (several reads: chunked, split, streamed or ranged; or, on a
    card, more bytes than one staging slot, which go as several
    transfers) lands in a private buffer on the target's device,
    allocated on first use and, on a card, charged to the scheduler's
    device budget; finalize publishes it into the template with one
    ``copy_`` once every byte has verified and landed, so a failed
    restore never leaves a torn leaf. Without an adoptable template the
    private buffer is the result.
    """

    def __init__(
        self,
        sizes: List[int],
        dtype: torch.dtype,
        device: torch.device,
        template: Optional[torch.Tensor],
    ) -> None:
        self.sizes = sizes
        self.dtype = dtype
        self.device = device
        self.nbytes = _nbytes(sizes, dtype.itemsize)
        self.template = template
        self.direct = False
        self.buffer: Optional[torch.Tensor] = None
        # Writes into the box (and the publish) are ordered after the work
        # queued so far on the restoring thread's current stream, the
        # template's stream: its private buffers are allocated there, and
        # every transfer waits for ``ready``, recorded on it now.
        self.stream = None
        self.ready = None
        if device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.ready = torch.cuda.Event()
            self.ready.record(self.stream)
        self.device_charged = False
        self._device_release: Optional[Callable[[int], None]] = None
        self._lock = threading.Lock()

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def ensure_buffer(self) -> torch.Tensor:
        with self._lock:
            if self.buffer is None:
                if self.direct:
                    self.buffer = self.template
                elif self.is_cuda:
                    with torch.cuda.stream(self.stream):
                        self.buffer = torch.empty(self.sizes, dtype=self.dtype, device=self.device)
                else:
                    self.buffer = torch.empty(self.sizes, dtype=self.dtype)
            return self.buffer

    def device_cost_bytes(self, landing: int = 0) -> int:
        """Device bytes a consume of this region deposits: the private
        buffer, charged once by the first admitted consume, plus a
        consume's own landing buffer for an on-card scatter."""
        if not self.is_cuda:
            return 0
        own = 0 if self.direct or self.device_charged else self.nbytes
        return own + landing

    def take_device_charge(self, release: Callable[[int], None]) -> None:
        if self.is_cuda and not self.direct and not self.device_charged:
            self.device_charged = True
            self._device_release = release

    def release_device_charge(self) -> None:
        release, self._device_release = self._device_release, None
        if release is not None:
            release(self.nbytes)


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """The bytes of contiguous ``t`` as uint8 of shape ``t.shape + [itemsize]``."""
    return t.reshape(-1).view(torch.uint8).reshape(list(t.shape) + [t.element_size()])


def _whole(slices: Tuple[slice, ...], shape: List[int]) -> bool:
    return all(sl.start == 0 and sl.stop == n for sl, n in zip(slices, shape))


class _ChunkCopyConsumer(BufferConsumer):
    """Places one read's payload (a whole stored object, whose checksum
    is verified first and which is then decompressed if it was stored
    compressed, or exactly its overlap with the box, from a ranged read)
    into the plan's region through the H2D pipeline, and tells the plan
    once the bytes have landed."""

    def __init__(
        self,
        plan: "ArrayRestorePlan",
        view_shape: List[int],
        view_slices: Tuple[slice, ...],
        target_slices: Tuple[slice, ...],
        checksum: Optional[str],
        location: str,
        compression: Optional[str] = None,
    ) -> None:
        self._plan = plan
        self._view_shape = view_shape
        self._view_slices = view_slices
        self._target_slices = target_slices
        self._checksum = checksum
        self._location = location
        self._compression = compression
        self._nbytes = _nbytes(view_shape, plan.itemsize)
        self._cost_release: Optional[Callable[[int], None]] = None
        self._device_release: Optional[Callable[[int], None]] = None
        self._profile = _cprof.current()

    def _landing_bytes(self) -> int:
        """A box that is not one run of a CUDA region lands whole on the
        card and is cut there."""
        region = self._plan.region
        if region.is_cuda and self._plan.target_run(self._view_shape, self._view_slices,
                                                    self._target_slices) is None:
            return self._nbytes
        return 0

    def get_consuming_cost_bytes(self) -> int:
        return self._nbytes

    def get_deferred_cost_bytes(self) -> int:
        # The payload (or its pinned copy) is read by the pipeline after
        # the consume returns: held until the transfer lands.
        return self._nbytes

    def get_progress_bytes(self) -> int:
        return self._nbytes

    def set_cost_releaser(self, release: Callable[[int], None]) -> None:
        self._cost_release = release

    def get_device_cost_bytes(self) -> int:
        return self._plan.region.device_cost_bytes(self._landing_bytes())

    def set_device_cost_releaser(self, release: Callable[[int], None]) -> None:
        self._plan.region.take_device_charge(release)
        self._device_release = release

    async def consume_buffer(self, buf: BufferType, executor: Optional[Executor] = None) -> None:
        await _in_executor(executor, lambda: self._consume(buf))

    async def consume_lease(
        self, lease: staging_pool.StagingLease, executor: Optional[Executor] = None
    ) -> None:
        """Consume a payload assembled in a staging lease; the pipeline
        reads the lease directly when it is pinned (or the target is the
        CPU), and holds it until the bytes have landed."""
        await _in_executor(executor, lambda: self._consume(None, lease))

    def _consume(self, buf: Optional[BufferType], lease: Optional[staging_pool.StagingLease] = None) -> None:
        with _cprof.consume_section():
            # A lease's buffer is a host tensor that storage reads filled:
            # its .numpy() is a view and waits on no device work.
            # snapcheck: disable=event-loop-blocking -- host staging buffer, no device sync
            data = buf if lease is None else memoryview(lease.buffer.numpy())
            with _cprof.substep(self._profile, "verify", len(data)):
                verify_checksum(data, self._checksum)
            if self._compression is not None:
                with _cprof.substep(self._profile, "decode", len(data)):
                    data = decompress_payload(data, self._compression)
            if len(data) != self._nbytes:
                raise RuntimeError(
                    f"{self._location}: read {len(data)} bytes where the "
                    f"manifest describes {self._nbytes}"
                )
            fut = self._plan.place(
                data, lease, self._view_shape, self._view_slices, self._target_slices
            )
            fut.add_done_callback(self._landed)

    def _landed(self, fut: Future) -> None:
        landing = self._landing_bytes()
        release, self._device_release = self._device_release, None
        if release is not None and landing:
            release(landing)
        release, self._cost_release = self._cost_release, None
        if release is not None:
            release(self._nbytes)
        if not fut.cancelled() and fut.exception() is None:
            self._plan.on_req_done()


class _PooledAssemblyState:
    """Budget plumbing for a read state that assembles ONE stored object
    in a buffer from the staging pool: the scheduler's deferred-cost
    releaser (charged with the first sub-read) fires exactly once, when
    the buffer returns to the pool, whichever of the buffer's acquisition
    and the scheduler's dispatch hook comes first."""

    def __init__(self, nbytes: int, pinned: bool = False) -> None:
        self.nbytes = nbytes
        self._pinned = pinned
        self._lease: Optional[staging_pool.StagingLease] = None
        self._lock = threading.Lock()
        self._profile = _cprof.current()
        self._cost_release: Optional[Callable[[int], None]] = None

    def set_cost_releaser(self, release: Callable[[int], None]) -> None:
        with self._lock:
            lease = self._lease
            if lease is None:
                self._cost_release = release
        if lease is not None:
            lease.set_budget_release(release, self.nbytes)

    def _ensure_buf(self) -> staging_pool.StagingLease:
        with self._lock:
            if self._lease is not None:
                return self._lease
            lease = staging_pool.acquire(self.nbytes, self._profile, self._pinned)
            # Reachable from self before anything else can raise: the
            # release path then returns it (and fires the re-credit).
            self._lease = lease
            release, self._cost_release = self._cost_release, None
        if release is not None:
            lease.set_budget_release(release, self.nbytes)
        return lease

    def _release_assembly_buffer(self) -> None:
        """Give the assembly buffer back (the pool fires the re-credit
        once it has returned); idempotent."""
        with self._lock:
            lease, self._lease = self._lease, None
            release, self._cost_release = self._cost_release, None
        if lease is not None:
            if release is not None:
                lease.set_budget_release(release, self.nbytes)
            lease.release()
        elif release is not None:
            release(self.nbytes)


class _SplitObjectReadState(_PooledAssemblyState):
    """Assembles concurrent ranged sub-reads of ONE stored object in a
    pooled buffer, then hands the whole payload to the inner consumer
    (``consume_lease``), so the checksum still covers the whole object.
    The lease goes back to the pool once the inner consumer's transfer
    (which holds it) has landed."""

    def __init__(self, nbytes: int, inner: Any, pinned: bool = False) -> None:
        super().__init__(nbytes, pinned)
        self._inner = inner
        self._remaining = 0
        self._device_charged = False

    def extra_first_cost_bytes(self) -> int:
        """Charged on top of the first sub-read: the assembly buffer."""
        return self.nbytes

    def deferred_cost_bytes(self, first: bool, part_nbytes: int) -> int:
        """The assembly buffer, carried by the first sub-read, outlives
        every sub-read's consume."""
        return self.nbytes if first else 0

    def device_cost_bytes(self) -> int:
        # The inner consumer's device bytes, charged once, by the first
        # of the sub-reads admitted.
        return 0 if self._device_charged else self._inner.get_device_cost_bytes()

    def set_device_cost_releaser(self, release: Callable[[int], None]) -> None:
        self._device_charged = True
        self._inner.set_device_cost_releaser(release)

    def add_sub_reads(self, path: str, part_size: int, base: int = 0) -> List[ReadReq]:
        """One ranged read per ``part_size`` bytes; ``base`` shifts the
        ranges (a split of a sub-range of the object)."""
        starts = list(range(0, self.nbytes, part_size))
        self._remaining = len(starts)
        return [
            ReadReq(
                path=path,
                buffer_consumer=_SubRangeConsumer(
                    self, start, min(start + part_size, self.nbytes), first=(i == 0)
                ),
                byte_range=(base + start, base + min(start + part_size, self.nbytes)),
            )
            for i, start in enumerate(starts)
        ]

    def _land_part(self, start: int, end: int, buf: BufferType) -> None:
        lease = self._ensure_buf()
        with _cprof.substep(self._profile, "reassemble", end - start):
            _check_part(buf, start, end)
            # Disjoint ranges: concurrent threads never overlap.
            host_copy(lease.buffer[start:end], buf)

    async def absorb(
        self, start: int, end: int, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        def _copy() -> None:
            with _cprof.consume_section():
                self._land_part(start, end, buf)

        await _in_executor(executor, _copy)
        with self._lock:
            self._remaining -= 1
            last = self._remaining == 0
        if last:
            try:
                await self._inner.consume_lease(self._lease, executor)
            finally:
                with _cprof.consume_section(), _cprof.substep(
                    self._profile, "staging_release", self.nbytes
                ):
                    self._release_assembly_buffer()


def _content_chunk_reads(
    state: Any,
    records: List[Dict[str, Any]],
    store_base: Optional[int],
    selected: Optional[List[int]] = None,
) -> Tuple[List[ReadReq], Dict[int, Dict[str, Any]]]:
    """One read per content chunk record of a chunk-stored object (from
    the store root, ``@base<store_base>/``), each consumed as bytes
    [offset, offset + n) of the object: (reads, record by offset). With
    ``selected`` (chunk pushdown), only those record indices are read;
    offsets stay those of the whole object."""
    from .chunkstore import chunk_object_path
    from .storage_plugin import make_ref_location

    wanted = None if selected is None else set(selected)
    reqs: List[ReadReq] = []
    by_offset: Dict[int, Dict[str, Any]] = {}
    offset = 0
    for i, rec in enumerate(records):
        n = int(rec["n"])
        if wanted is None or i in wanted:
            path = chunk_object_path(rec["k"])
            if store_base is not None:
                path = make_ref_location(store_base, path)
            by_offset[offset] = rec
            consumer = _SubRangeConsumer(state, offset, offset + n, first=not reqs)
            reqs.append(ReadReq(path=path, buffer_consumer=consumer))
        offset += n
    if offset != state.nbytes:
        raise RuntimeError(f"content chunks of {offset} bytes describe an object of {state.nbytes}")
    return reqs, by_offset


def _pushdown_cut(
    records: List[Dict[str, Any]], shape: List[int], slices: Tuple[slice, ...], itemsize: int
) -> Optional[List[int]]:
    """Chunk pushdown: the indices of the content records whose bytes
    intersect the C-order byte hull of ``slices`` of a chunk-stored
    object of ``shape``, or None when every record is needed (or
    ``TPUSNAPSHOT_CHUNK_PUSHDOWN=0``). The hull is a superset of the
    strided footprint, and the scatter reads only the slices' elements,
    so unread records are never observed."""
    if os.environ.get("TPUSNAPSHOT_CHUNK_PUSHDOWN") == "0":
        return None
    from .snapserve import pushdown

    sizes = [int(r["n"]) for r in records]
    box = [tuple((sl.start, sl.stop) for sl in slices)]
    sel = pushdown.select_records(sizes, pushdown.needed_intervals(tuple(shape), box, itemsize))
    if not 0 < len(sel.indices) < len(records):
        return None
    telemetry.counter(_metric_names.CHUNK_PUSHDOWN_SKIPPED_BYTES).inc(
        sum(sizes) - sel.selected_bytes
    )
    return sel.indices


class _ContentChunksReadState(_SplitObjectReadState):
    """Assembles the content chunks of ONE chunk-stored object (a
    ``chunks`` entry of the chunk store) in a pooled buffer, each decoded
    and content-verified as it lands, then hands the whole payload to the
    inner consumer: the chunk-store mirror of the split read, for an
    object that is not one run of the target box. A chunk this manifest
    only references is verified against its content key, since no
    checksum of this take covers it."""

    def __init__(self, nbytes: int, inner: Any, dtype_name: str, pinned: bool = False) -> None:
        super().__init__(nbytes, inner, pinned)
        self._dtype_name = dtype_name
        self._by_offset: Dict[int, Dict[str, Any]] = {}

    def build_reads(
        self, records: List[Dict[str, Any]], store_base: Optional[int],
        selected: Optional[List[int]] = None,
    ) -> List[ReadReq]:
        reqs, self._by_offset = _content_chunk_reads(self, records, store_base, selected)
        self._remaining = len(reqs)
        return reqs

    def _land_part(self, start: int, end: int, buf: BufferType) -> None:
        from .chunkstore import decode_and_verify_chunk

        lease = self._ensure_buf()
        out = memoryview(lease.buffer.numpy())[start:end]
        logical = decode_and_verify_chunk(
            self._by_offset[start], self._dtype_name, buf, profile=self._profile, out=out
        )
        if logical is not None:
            with _cprof.substep(self._profile, "reassemble", len(logical)):
                host_copy(lease.buffer[start:end], logical)


def _all_of(futures: List[Future]) -> Future:
    """A future that resolves once all ``futures`` have, with the first
    one's exception if any failed."""
    if len(futures) == 1:
        return futures[0]
    out: Future = Future()
    if not futures:
        out.set_result(None)
        return out
    lock = threading.Lock()
    remaining = [len(futures)]

    def _one_done(_: Future) -> None:
        with lock:
            remaining[0] -= 1
            if remaining[0]:
                return
        for fut in futures:
            exc = RuntimeError("a transfer was cancelled") if fut.cancelled() else fut.exception()
            if exc is not None:
                out.set_exception(exc)
                return
        out.set_result(None)

    for fut in futures:
        fut.add_done_callback(_one_done)
    return out


def _check_part(buf: BufferType, start: int, end: int) -> None:
    if len(buf) != end - start:
        raise RuntimeError(
            f"Ranged sub-read returned {len(buf)} bytes for [{start}, {end}): "
            f"the object is shorter than the manifest says (truncated or torn)."
        )


class _StreamingSplitState(_SplitObjectReadState):
    """Split read of one large object that is one run of the region:
    each sub-range goes to the region's private buffer at its flat offset
    (on a card: staged in a pinned pooled buffer and DMA'd there by the
    H2D pipeline) as soon as it lands, so storage reads overlap the
    transfers. No host assembly buffer, no per-piece device arrays.

    The crc32 folds incrementally over the in-order byte stream
    (out-of-order parts wait in a stash until their prefix lands) and is
    checked before the plan can publish; a mismatch raises with nothing
    published. A part's host reservation is re-credited once both its
    holds drop: the crc stash and the transfer."""

    def __init__(
        self,
        plan: "ArrayRestorePlan",
        nbytes: int,
        flat_base: int,
        checksum: Optional[str],
    ) -> None:
        super().__init__(nbytes, inner=None)
        self._plan = plan
        self._flat_base = flat_base
        self._checksum = checksum
        self._crc: Optional[StreamingCrc32] = (
            StreamingCrc32() if checksum and checksum.startswith("crc32:") else None
        )
        self._next_off = 0
        self._stash: Dict[int, BufferType] = {}
        self._released = 0  # deferred bytes already re-credited
        self._part_refs: Dict[int, int] = {}
        self._transfers_remaining = 0
        self._crc_ok = self._crc is None
        self._completed = False
        self._failed = False

    def extra_first_cost_bytes(self) -> int:
        return 0

    def deferred_cost_bytes(self, first: bool, part_nbytes: int) -> int:
        return part_nbytes

    def device_cost_bytes(self) -> int:
        return self._plan.region.device_cost_bytes()

    def set_device_cost_releaser(self, release: Callable[[int], None]) -> None:
        self._plan.region.take_device_charge(release)

    def add_sub_reads(self, path: str, part_size: int, base: int = 0) -> List[ReadReq]:
        reqs = super().add_sub_reads(path, part_size, base)
        self._transfers_remaining = len(reqs)
        return reqs

    def _release_assembly_cost(self) -> None:
        # Error-path safety net: re-credit what the per-part holds have
        # not (on success they covered the whole object: a no-op).
        release, self._cost_release = self._cost_release, None
        if release is not None:
            with self._lock:
                remaining = self.nbytes - self._released
                self._released = self.nbytes
            if remaining > 0:
                release(remaining)

    def _part_release(self, start: int, nbytes: int) -> None:
        release = None
        with self._lock:
            refs = self._part_refs.get(start)
            if refs is None:
                return
            refs -= 1
            if refs:
                self._part_refs[start] = refs
                return
            del self._part_refs[start]
            release = self._cost_release
            if release is not None:
                self._released += nbytes
        if release is not None:
            release(nbytes)

    def _transfer_done(self, start: int, nbytes: int, fut: Future) -> None:
        if fut.cancelled() or fut.exception() is not None:
            # The restore is failing: the plan surfaces the registered
            # future's error before it publishes anything. Never complete
            # over a partial deposit; free the remaining holds now.
            with self._lock:
                self._failed = True
            self._release_assembly_cost()
            return
        with self._lock:
            self._transfers_remaining -= 1
        self._part_release(start, nbytes)
        self._maybe_complete()

    def _maybe_complete(self) -> None:
        with self._lock:
            if (
                self._completed
                or self._failed
                or not self._crc_ok
                or self._remaining != 0
                or self._transfers_remaining != 0
            ):
                return
            self._completed = True
        try:
            self._plan.on_req_done()
        finally:
            self._release_assembly_cost()

    def _payload(self, start: int, end: int, buf: BufferType) -> BufferType:
        """The bytes [start, end) of the object that the read ``buf``
        carries: the read itself, for a ranged sub-read."""
        return buf

    async def absorb(
        self, start: int, end: int, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        def _consume_part() -> None:
            nonlocal buf
            with _cprof.consume_section():
                buf = self._payload(start, end, buf)
                _check_part(buf, start, end)
                with self._lock:
                    self._part_refs[start] = 2 if self._crc is not None else 1
                # The transfer first: it rides the link while the crc
                # fold below runs and later sub-reads arrive.
                lo = self._flat_base + start
                fut = self._plan.place_run(buf, lo, lo + (end - start))
                fut.add_done_callback(
                    lambda f, s=start, n=end - start: self._transfer_done(s, n, f)
                )
                if self._crc is None:
                    return
                with _cprof.substep(self._profile, "verify", len(buf)):
                    drained: List[Tuple[int, int]] = []
                    with self._lock:
                        self._stash[start] = buf
                        while self._next_off in self._stash:
                            off = self._next_off
                            b = self._stash.pop(off)
                            self._crc.update(b)
                            self._next_off += len(b)
                            drained.append((off, len(b)))
                        stream_done = self._next_off >= self.nbytes
                    for off, n in drained:
                        self._part_release(off, n)
                    if stream_done:
                        actual = self._crc.tag()
                        if actual != self._checksum:
                            with self._lock:
                                self._failed = True
                            raise RuntimeError(
                                f"Checksum mismatch: stored object is corrupt "
                                f"(expected {self._checksum}, got {actual})."
                            )
                        with self._lock:
                            self._crc_ok = True

        await _in_executor(executor, _consume_part)
        with self._lock:
            self._remaining -= 1
        self._maybe_complete()


class _StreamedContentChunksState(_StreamingSplitState):
    """The content chunks of ONE chunk-stored object that is one run of
    the region: each chunk is decoded and content-verified as it lands
    and goes on to the region's private buffer at its offset, as a
    streamed sub-range does, with no host assembly buffer. The leaf
    publishes only once every chunk has verified and landed."""

    def __init__(self, plan: "ArrayRestorePlan", nbytes: int, flat_base: int, dtype_name: str) -> None:
        super().__init__(plan, nbytes, flat_base, checksum=None)
        self._dtype_name = dtype_name
        self._by_offset: Dict[int, Dict[str, Any]] = {}

    def build_reads(self, records: List[Dict[str, Any]], store_base: Optional[int]) -> List[ReadReq]:
        reqs, self._by_offset = _content_chunk_reads(self, records, store_base)
        self._remaining = self._transfers_remaining = len(reqs)
        return reqs

    def _payload(self, start: int, end: int, buf: BufferType) -> BufferType:
        from .chunkstore import decode_and_verify_chunk

        return decode_and_verify_chunk(self._by_offset[start], self._dtype_name, buf, profile=self._profile)


class _SubRangeConsumer(BufferConsumer):
    """One ranged sub-read of a split whole-object read."""

    def __init__(self, state: _SplitObjectReadState, start: int, end: int, first: bool) -> None:
        self._state = state
        self._start = start
        self._end = end
        self._first = first

    async def consume_buffer(self, buf: BufferType, executor: Optional[Executor] = None) -> None:
        await self._state.absorb(self._start, self._end, buf, executor)

    def get_consuming_cost_bytes(self) -> int:
        # Its own payload; the first also carries the state's shared
        # assembly buffer (none for a streaming state). The scheduler
        # dispatches one object's sub-reads in order, first first.
        extra = self._state.extra_first_cost_bytes() if self._first else 0
        return (self._end - self._start) + extra

    def get_deferred_cost_bytes(self) -> int:
        return self._state.deferred_cost_bytes(self._first, self._end - self._start)

    def get_progress_bytes(self) -> int:
        return self._end - self._start

    def set_cost_releaser(self, release: Callable[[int], None]) -> None:
        self._state.set_cost_releaser(release)

    @property
    def sort_key_bytes(self) -> int:
        return self._state.nbytes

    def get_device_cost_bytes(self) -> int:
        # The region's private buffer is charged once, by the first of
        # its consumes admitted; completing a started region is free.
        return self._state.device_cost_bytes()

    def set_device_cost_releaser(self, release: Callable[[int], None]) -> None:
        self._state.set_device_cost_releaser(release)


# Finalize executor: a finalize triggered from an H2D pipeline callback
# must not run on the pipeline's worker, which would block in
# await_pipeline on transfers queued behind itself (a deadlock at depth
# 1). Such finalizes hop here; this pool waits on the pipeline, never the
# reverse.
_finalize_pool: Optional[ThreadPoolExecutor] = None
_finalize_pool_lock = threading.Lock()


def _get_finalize_pool() -> ThreadPoolExecutor:
    global _finalize_pool
    with _finalize_pool_lock:
        if _finalize_pool is None:
            _finalize_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="tpusnapshot-finalize"
            )
        return _finalize_pool


class ArrayRestorePlan:
    """Restores one array entry (dense or chunked or sharded) into one
    target box.

    A tensor (or numpy, or absent) template takes the whole array, on
    the template's device (the CPU for numpy or none). A DTensor template
    takes its local box (:func:`dtensor_box`) and the result is a DTensor
    with the template's mesh and placements. JAX PRNG-key leaves restore
    as their raw uint32 key data: the port has no key type.

    Every byte goes to the box through the H2D pipeline as its read
    verifies (:class:`_TargetRegion` says where). The last landing
    triggers :meth:`finalize`, which publishes the leaf; a failed read,
    consume or transfer leaves the template as it was.
    """

    def __init__(self, entry: Entry, template: Any, callback: Callable[[Any], None]):
        if isinstance(entry, ShardedArrayEntry):
            shards = list(entry.shards)
        elif isinstance(entry, ArrayEntry):
            shards = [Shard([0] * len(entry.shape), list(entry.shape), entry)]
        else:
            raise TypeError(f"Not an array entry: {type(entry)}")
        shape = list(entry.shape)
        dtype = str_to_torch_dtype(entry.dtype)
        self.itemsize = dtype_itemsize(entry.dtype)
        self._shards = shards
        self._callback = callback
        # The plan is built in the restoring thread, under the restore's
        # trace scope; finalize may run on the finalize pool or an H2D
        # worker, whose contexts carry no trace. Capture it (and the span
        # building the plan) now and adopt them in _finalize_now.
        self._trace_id = tracing.current_trace_id()
        self._trace_parent = tracing.current_span_id()
        self._as_numpy = isinstance(template, np.ndarray)
        self._wrap: Optional[Tuple[Any, Any, Any, Any]] = None
        key_data = entry.prng_impl is not None
        if (
            template is not None
            and hasattr(template, "shape")
            and list(template.shape) != shape
            and not key_data
        ):
            raise RuntimeError(
                f"Cannot restore array of shape {shape} into a template "
                f"of shape {list(template.shape)}. Shapes must match; "
                f"resharding (another mesh or placements) is supported, "
                f"reshaping is not."
            )
        if is_dtensor(template):
            box = dtensor_box(template)
            local = template.to_local()
            if box is None:
                box = ([0] * len(shape), [0] * len(shape))
            elif list(local.shape) != box[1]:
                raise RuntimeError(
                    f"DTensor template's local tensor has shape "
                    f"{list(local.shape)}; its placements give the box {box[1]}"
                )
            self._wrap = (template.device_mesh, template.placements, template.shape, template.stride())
        else:
            box = ([0] * len(shape), shape)
            local = template
        self._box_offsets, box_sizes = box
        adopt = None
        device = torch.device("cpu")
        if isinstance(local, torch.Tensor):
            device = local.device
            if (
                local.dtype == dtype
                and list(local.shape) == box_sizes
                and local.is_contiguous()
            ):
                adopt = local.detach()
        self.region = _TargetRegion(list(box_sizes), dtype, device, adopt)
        # Bytes read as streamed sub-ranges (the rest arrive whole).
        self.streamed_bytes = 0
        self._profile = _cprof.current()
        self._lock = threading.Lock()
        # Completion: one count per logical read (a whole or ranged read,
        # or a split object), down when its bytes have verified and landed.
        self._outstanding = 0
        self._complete = threading.Event()
        self._transfers: List[Future] = []
        self._finalized = False
        self._abandoned = False
        self._finalize_done = threading.Event()
        self._finalize_error: Optional[BaseException] = None

    # ---------------------------------------------------------- placing
    def target_run(
        self, shape: List[int], src_slices: Tuple[slice, ...], target_slices: Tuple[slice, ...]
    ) -> Optional[Tuple[int, int]]:
        """The byte run of the region that a whole source box fills, or
        None when the source is cut or the box is not one run."""
        if not _whole(src_slices, shape):
            return None
        return contiguous_byte_range(self.region.sizes, target_slices, self.itemsize)

    def _submit(self, src: Any, dst: torch.Tensor, then: Any = None,
                lease: Optional[staging_pool.StagingLease] = None) -> Future:
        fut = h2d_pipeline().submit(
            src, dst, profile=self._profile, ready=self.region.ready, then=then, lease=lease
        )
        with self._lock:
            self._transfers.append(fut)
        return fut

    def _pinned_source(
        self, data: BufferType, lease: Optional[staging_pool.StagingLease]
    ) -> Tuple[staging_pool.StagingLease, bool]:
        """A pinned lease holding ``data`` for a DMA, and whether the
        caller owns it (and must release it once submitted)."""
        if lease is not None and lease.pinned:
            return lease, False
        staged = staging_pool.acquire(len(data), self._profile, pinned=True)
        try:
            with _cprof.substep(self._profile, "reassemble", len(data)):
                host_copy(staged.buffer, data)
        except BaseException:
            # The caller releases only a lease it was handed.
            staged.release()
            raise
        return staged, True

    def place_run(self, data: BufferType, lo: int, hi: int) -> Future:
        """Send the payload ``data`` to bytes [lo, hi) of the region.

        On a card it goes piece by piece through pinned staging slots of
        ``transfer.H2D_CHUNK_BYTES``, every slot one size whatever the
        object's: a consume holds a bounded part of the pool, each piece's
        DMA overlaps the copy of the next, and the pool's buffers, all of
        one key, serve every later restore without new pinned memory.
        Pieces land independently, so a run of several pieces goes to a
        private buffer, never straight to the template."""
        dst = self.region.ensure_buffer().reshape(-1).view(torch.uint8)[lo:hi]
        if not self.region.is_cuda:
            return self._submit(np.frombuffer(data, dtype=np.uint8), dst)
        view = memoryview(data).cast("B")
        slot = transfer.H2D_CHUNK_BYTES
        futures = []
        for start in range(0, hi - lo, slot):
            end = min(start + slot, hi - lo)
            staged = staging_pool.acquire(slot, self._profile, pinned=True)
            try:
                src = staged.buffer[: end - start]
                with _cprof.substep(self._profile, "reassemble", end - start):
                    host_copy(src, view[start:end])
                futures.append(self._submit(src, dst[start:end], lease=staged))
            finally:
                staged.release()
        return _all_of(futures)

    def place(
        self,
        data: BufferType,
        lease: Optional[staging_pool.StagingLease],
        shape: List[int],
        src_slices: Tuple[slice, ...],
        target_slices: Tuple[slice, ...],
    ) -> Future:
        """Send box ``src_slices`` of the C-order array ``data`` (of
        ``shape``; held by ``lease`` when given) to box ``target_slices``
        of the region."""
        region = self.region
        run = self.target_run(shape, src_slices, target_slices)
        if run is not None and lease is None:
            return self.place_run(data, *run)
        dst = region.ensure_buffer()
        nbytes = _nbytes(shape, self.itemsize)
        if not region.is_cuda:
            src = np.frombuffer(data, dtype=np.uint8, count=nbytes)
            if run is not None:
                return self._submit(src, dst.reshape(-1).view(torch.uint8)[run[0]:run[1]], lease=lease)
            src_box = src.reshape(list(shape) + [self.itemsize])[src_slices]
            return self._submit(src_box, _byte_view(dst)[target_slices], lease=lease)
        staged, own = self._pinned_source(data, lease)
        try:
            src = staged.buffer[:nbytes]
            if run is not None:
                return self._submit(src, dst.reshape(-1).view(torch.uint8)[run[0]:run[1]], lease=staged)
            # Not one run of the target: land the source whole on the
            # card and cut the box there (no gather on the host).
            with torch.cuda.stream(region.stream):
                landing = torch.empty(nbytes, dtype=torch.uint8, device=region.device)

            def scatter() -> None:
                typed = landing.view(region.dtype).reshape(shape)
                dst[target_slices].copy_(typed[src_slices])

            return self._submit(src, landing, then=scatter, lease=staged)
        finally:
            if own:
                staged.release()

    # ------------------------------------------------------- completion
    def on_req_done(self) -> None:
        with self._lock:
            self._outstanding -= 1
            if self._outstanding != 0:
                return
        self._complete.set()
        self.finalize()

    def build_read_reqs(self) -> List[ReadReq]:
        """Reads for every stored object that overlaps the box:

        - an object that is one run of the box and larger than the
          parallel-read threshold streams: concurrent sub-reads, each
          sent to the device as it lands;
        - an overlap that is one run of its object, and not all of it, is
          a ranged read of exactly those bytes (unverifiable, so under
          ``TPUSNAPSHOT_STRICT_INTEGRITY=1`` the whole object is read);
        - everything else reads the whole object (verified), split into
          concurrent sub-reads assembled in a pooled buffer when large.
        """
        region = self.region
        itemsize = self.itemsize
        threshold = _parallel_read_threshold()
        part = max(itemsize, threshold - threshold % itemsize)
        strict = os.environ.get(_STRICT_INTEGRITY_ENV_VAR) == "1"
        # (shard, overlap, byte range of a ranged read or None, split)
        planned = []
        for shard in self._shards:
            ov = compute_overlap(shard.offsets, shard.sizes, self._box_offsets, region.sizes)
            if ov is None:
                continue
            obj_nbytes = _nbytes(shard.sizes, itemsize)
            # A compressed or content-chunked object reads whole, never
            # ranged, split or streamed: its stored bytes are not the
            # payload's.
            whole_only = shard.array.compression is not None or bool(shard.array.chunks)
            rng = contiguous_byte_range(shard.sizes, ov.chunk_slices, itemsize)
            if rng == (0, obj_nbytes) or strict or whole_only:
                rng = None
            read_nbytes = obj_nbytes if rng is None else rng[1] - rng[0]
            planned.append((shard, ov, rng, read_nbytes > threshold and not whole_only))
        # One verified whole-object read carries the whole leaf, and one
        # transfer takes it to the template: its bytes may land there
        # straight. Several transfers (a run of more than one staging
        # slot) could fail after the first has written.
        region.direct = (
            region.template is not None
            and len(planned) == 1
            and planned[0][2] is None
            and not planned[0][3]
            and not planned[0][0].array.chunks
            and (not region.is_cuda or region.nbytes <= transfer.H2D_CHUNK_BYTES)
        )
        reqs: List[ReadReq] = []
        for shard, ov, rng, split in planned:
            location = shard.array.location
            if rng is None:
                view = (list(shard.sizes), ov.chunk_slices, shard.array.checksum)
            else:
                view = (list(ov.sizes), tuple(slice(0, n) for n in ov.sizes), None)
            run = self.target_run(view[0], view[1], ov.target_slices)
            base = 0 if rng is None else rng[0]
            if split and run is not None:
                stream = _StreamingSplitState(
                    self, _nbytes(view[0], itemsize), run[0], view[2]
                )
                reqs.extend(stream.add_sub_reads(location, part, base))
                self.streamed_bytes += stream.nbytes
                continue
            stored = shard.array
            if stored.chunks:
                nbytes = _nbytes(view[0], itemsize)
                if run is not None:
                    # The box takes the whole object: every chunk is read.
                    state = _StreamedContentChunksState(self, nbytes, run[0], stored.dtype)
                    self.streamed_bytes += nbytes
                    reqs.extend(state.build_reads(stored.chunks, stored.base))
                else:
                    consumer = _ChunkCopyConsumer(self, *view[:2], ov.target_slices, None, location)
                    state = _ContentChunksReadState(nbytes, consumer, stored.dtype, pinned=region.is_cuda)
                    # Strict integrity verifies every chunk, so reads all.
                    selected = None if strict else _pushdown_cut(stored.chunks, view[0], view[1], itemsize)
                    reqs.extend(state.build_reads(stored.chunks, stored.base, selected))
                continue
            consumer = _ChunkCopyConsumer(
                self, *view[:2], ov.target_slices, view[2], location, stored.compression
            )
            if split:
                state = _SplitObjectReadState(
                    _nbytes(view[0], itemsize), consumer, pinned=region.is_cuda
                )
                reqs.extend(state.add_sub_reads(location, part, base))
            else:
                reqs.append(ReadReq(path=location, buffer_consumer=consumer, byte_range=rng))
        with self._lock:
            self._outstanding = len(planned)
        if not planned:
            region.direct = region.template is not None
            self._complete.set()
        return reqs

    def finalize(self) -> None:
        """Publish the leaf once every byte has verified and landed.

        Normally triggered by the last landing; the restore also calls
        it for every plan after the pipeline, and that call waits for an
        eager finalize in progress and re-raises its error."""
        with self._lock:
            if self._abandoned:
                return
            run = not self._finalized
            self._finalized = True
        if not run:
            self._finalize_done.wait()
            if self._finalize_error is not None:
                raise self._finalize_error
            return
        if on_h2d_thread():
            _get_finalize_pool().submit(self._finalize_now)
            return
        self._finalize_now()

    def _finalize_now(self) -> None:
        try:
            self.await_pipeline()
            with tracing.adopt_trace(self._trace_id, self._trace_parent), tracing.span("assemble"):
                self._publish()
        except BaseException as e:
            # On the finalize pool the raise lands in an unread future;
            # the restore's own finalize call re-raises it.
            self._finalize_error = e
            raise
        finally:
            self._finalize_done.set()

    def await_pipeline(self) -> None:
        """Wait out, and surface the errors of, every transfer this plan
        submitted, BEFORE anything is published: a failed transfer or an
        incomplete pipeline raises, and the template stays untouched."""
        with self._lock:
            transfers = list(self._transfers)
        for fut in transfers:
            fut.result()
        with self._lock:
            outstanding = self._outstanding
        if outstanding == 0:
            return
        # Every future has resolved; the only legitimate gap is a
        # done-callback still running on another thread.
        if not self._complete.wait(timeout=60.0):
            raise RuntimeError(
                f"restore pipeline incomplete: {outstanding} read(s) never "
                f"finished verify/transfer; refusing to publish a torn leaf"
            )

    def settle(self) -> None:
        """After a failed restore: wait until no transfer of this plan is
        in flight and no finalize is running, raising nothing. A plan
        that has not started to publish never will."""
        with self._lock:
            transfers = list(self._transfers)
        futures_wait(transfers)
        with self._lock:
            started = self._finalized
            self._abandoned = not started
        if started:
            self._finalize_done.wait()

    def _publish(self) -> None:
        region = self.region
        out = region.ensure_buffer()
        if not region.direct and region.template is not None:
            with _cprof.substep(self._profile, "reassemble", region.nbytes):
                if region.is_cuda:
                    with torch.cuda.device(region.device), torch.cuda.stream(region.stream):
                        region.template.copy_(out)
                        done = torch.cuda.Event()
                        done.record(region.stream)
                    done.synchronize()
                else:
                    region.template.copy_(out)
            region.buffer = out = region.template
            region.release_device_charge()
        if self._wrap is not None:
            from torch.distributed.tensor import DTensor

            mesh, placements, shape, stride = self._wrap
            # from_local with the global shape and stride: no
            # communication, and uneven last shards keep their sizes.
            out = DTensor.from_local(
                out, mesh, placements, run_check=False, shape=shape, stride=stride
            )
        self._callback(out.numpy() if self._as_numpy else out)


def _prepare_array_write(
    arr: Any, logical_path: str, rank: int, replicated: bool, compression: Optional[str] = None
) -> Tuple[Entry, List[WriteReq]]:
    dtype_name = dtype_to_str(arr.dtype)
    shape = list(arr.shape)
    itemsize = dtype_itemsize(dtype_name)
    if _nbytes(shape, itemsize) <= MAX_CHUNK_SIZE_BYTES:
        location = get_storage_path(rank, logical_path, replicated)
        entry = ArrayEntry(
            location=location,
            serializer=ARRAY_SERIALIZER,
            dtype=dtype_name,
            shape=shape,
            replicated=replicated,
        )
        return entry, [WriteReq(location, ArrayBufferStager(arr, entry, compression=compression))]
    # Chunk objects live under their own top-level namespace, with the
    # JAX package's names: "chunked/<rank or replicated>/<path>__chunk_<i>".
    owner = "replicated" if replicated else str(rank)
    base = f"chunked/{owner}/{logical_path}"
    shards: List[Shard] = []
    reqs: List[WriteReq] = []
    pieces = subdivide([0] * len(shape), shape, itemsize, MAX_CHUNK_SIZE_BYTES)
    for i, (c_off, c_sz) in enumerate(pieces):
        location = f"{base}__chunk_{i}"
        chunk_entry = ArrayEntry(
            location=location,
            serializer=ARRAY_SERIALIZER,
            dtype=dtype_name,
            shape=list(c_sz),
            replicated=False,
        )
        shards.append(Shard(offsets=list(c_off), sizes=list(c_sz), array=chunk_entry))
        local = tuple(slice(o, o + s) for o, s in zip(c_off, c_sz))
        reqs.append(
            WriteReq(location, ArrayBufferStager(arr, chunk_entry, local, compression))
        )
    entry = ShardedArrayEntry(
        dtype=dtype_name,
        shape=shape,
        shards=shards,
        replicated=replicated,
        per_rank=not replicated,
    )
    return entry, reqs


def _prepare_sharded_array_write(
    dt: Any, logical_path: str, compression: Optional[str] = None
) -> Tuple[ShardedArrayEntry, List[WriteReq]]:
    """The local box of a sharded DTensor as shards of the global array.

    Exactly one rank writes each box: the one at coordinate 0 on every
    ``Replicate`` mesh dim (the JAX package's ``replica_id == 0``). A box
    above ``MAX_CHUNK_SIZE_BYTES`` is subdivided as the JAX package
    subdivides a shard."""
    from torch.distributed.tensor import Replicate

    local = dt.to_local().detach()
    dtype_name = dtype_to_str(local.dtype)
    itemsize = dtype_itemsize(dtype_name)
    global_shape = list(dt.shape)
    shards: List[Shard] = []
    reqs: List[WriteReq] = []
    box = dtensor_box(dt)
    coordinate = dt.device_mesh.get_coordinate()
    writer = box is not None and all(
        coordinate[d] == 0
        for d, p in enumerate(dt.placements)
        if isinstance(p, Replicate)
    )
    if writer and all(n > 0 for n in box[1]):
        off, sz = box
        if list(local.shape) != sz:
            raise RuntimeError(
                f"{logical_path}: the DTensor's local tensor has shape "
                f"{list(local.shape)}; its placements give the box {sz}"
            )
        pieces = subdivide(off, sz, itemsize, MAX_CHUNK_SIZE_BYTES)
        for c_off, c_sz in pieces:
            location = chunk_location(logical_path, c_off)
            entry = ArrayEntry(
                location=location,
                serializer=ARRAY_SERIALIZER,
                dtype=dtype_name,
                shape=list(c_sz),
                replicated=False,
            )
            shards.append(Shard(offsets=list(c_off), sizes=list(c_sz), array=entry))
            chunk_slices = None
            if len(pieces) > 1:
                chunk_slices = tuple(
                    slice(co - o, co - o + cs) for co, cs, o in zip(c_off, c_sz, off)
                )
            stager = ArrayBufferStager(local, entry, chunk_slices, compression)
            reqs.append(WriteReq(location, stager))
    return ShardedArrayEntry(dtype=dtype_name, shape=global_shape, shards=shards), reqs


def prepare_write(
    obj: Any,
    logical_path: str,
    rank: int,
    replicated: bool = False,
    compression: Optional[str] = None,
) -> Tuple[Entry, List[WriteReq]]:
    """Plan the persistence of one leaf value: its manifest entry and
    the write requests this rank is responsible for. For replicated
    values the caller drops the requests on ranks that do not own the
    write; a sharded DTensor is never replicated (its own writer rule
    applies). ``compression`` ("zlib" or None) compresses every stored
    payload."""
    if is_partitioned(obj):
        return _prepare_sharded_array_write(obj, logical_path, compression)
    if is_dtensor(obj):
        obj = obj.to_local()
    if isinstance(obj, torch.Tensor):
        return _prepare_array_write(obj.detach(), logical_path, rank, replicated, compression)
    # numpy scalars subclass Python numbers (np.float64 is a float), so the
    # array check must run before the primitive check.
    if isinstance(obj, (np.generic, np.ndarray)):
        return _prepare_array_write(np.asarray(obj), logical_path, rank, replicated, compression)
    if isinstance(obj, _PRIMITIVE_TYPES):
        return PrimitiveEntry.from_value(obj, replicated=replicated), []
    location = get_storage_path(rank, logical_path, replicated)
    entry = ObjectEntry(location=location, serializer=OBJECT_SERIALIZER, replicated=replicated)
    return entry, [WriteReq(location, ObjectBufferStager(obj, entry, compression))]


def prepare_read(
    entry: Entry, template: Any, callback: Callable[[Any], None]
) -> Tuple[List[ReadReq], List[ArrayRestorePlan]]:
    """Plan the restore of one leaf value into ``template``'s placement:
    read requests, plus the array plans whose ``await_pipeline`` and
    ``finalize`` the caller runs after the reads (``settle`` after a
    failed run)."""
    if isinstance(entry, PrimitiveEntry):
        callback(entry.get_value())
        return [], []
    if isinstance(entry, ObjectEntry):
        consumer = ObjectBufferConsumer(
            callback, checksum=entry.checksum, compression=entry.compression
        )
        return [ReadReq(path=entry.location, buffer_consumer=consumer)], []
    if isinstance(entry, (ArrayEntry, ShardedArrayEntry)):
        plan = ArrayRestorePlan(entry, template, callback)
        return plan.build_read_reqs(), [plan]
    raise TypeError(f"Cannot prepare read for entry type {type(entry)}")
