"""IO preparers: map values ⇄ manifest entries + write/read requests.

Three value classes, as in the JAX package:

- **dense arrays** (``torch.Tensor`` on the CPU or a CUDA device, or
  ``numpy.ndarray``) → ``ArrayEntry`` + one write of raw payload bytes;
  above ``MAX_CHUNK_SIZE_BYTES`` a chunked ``ShardedArrayEntry`` whose
  chunks are separate storage objects, split exactly as the JAX package
  splits them;
- **small scalars** → ``PrimitiveEntry``, inline in the manifest;
- **objects** (anything else picklable) → ``ObjectEntry``.

Staging copies a tensor's bytes into a private host buffer (pinned, for
a CUDA tensor) — tensors are mutable, so the payload must be a cut of the
value at take time. Restore routes every array entry through an
:class:`ArrayRestorePlan` that fills one target tensor chunk by chunk:
the template tensor itself when its device, dtype, shape and layout
match (the restore then holds one copy of the state on the card), a new
tensor on the template's device otherwise.
"""

import asyncio
from concurrent.futures import Executor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from .manifest import (
    ArrayEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    Shard,
    ShardedArrayEntry,
)
from .ops.transfer import device_clone, device_to_host, host_to_device
from .resharding import compute_overlap, contiguous_byte_range, subdivide
from .serialization import (
    ARRAY_SERIALIZER,
    OBJECT_SERIALIZER,
    bytes_to_object,
    compute_checksum,
    dtype_itemsize,
    dtype_to_str,
    object_to_bytes,
    str_to_torch_dtype,
    tensor_bytes,
    verify_checksum,
)

# Dense arrays above this size are stored as several chunk objects.
MAX_CHUNK_SIZE_BYTES: int = 512 * 1024 * 1024

_PRIMITIVE_TYPES = (int, float, bool, str, complex, type(None))


def get_storage_path(rank: int, logical_path: str, replicated: bool) -> str:
    if replicated:
        return f"replicated/{logical_path}"
    return f"{rank}/{logical_path}"


def _nbytes(sizes: List[int], itemsize: int) -> int:
    n = itemsize
    for s in sizes:
        n *= s
    return n


async def _in_executor(executor: Optional[Executor], fn: Callable[[], Any]) -> Any:
    if executor is None:
        return fn()
    return await asyncio.get_running_loop().run_in_executor(executor, fn)


class ArrayBufferStager(BufferStager):
    """Stages a tensor or numpy array (or the sub-box ``chunk_slices`` of
    one) into raw payload bytes and records their checksum in ``entry``."""

    def __init__(
        self,
        data: Any,
        entry: ArrayEntry,
        chunk_slices: Optional[Tuple[slice, ...]] = None,
    ) -> None:
        self._data = data
        self._entry = entry
        self._chunk_slices = chunk_slices
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
    clones = device_clone([sources[k] for k in order])
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
    def __init__(self, obj: Any, entry: ObjectEntry) -> None:
        self._buf = object_to_bytes(obj)
        self._entry = entry

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        self._entry.checksum = compute_checksum(self._buf)
        return self._buf

    def get_staging_cost_bytes(self) -> int:
        return len(self._buf)


class ObjectBufferConsumer(BufferConsumer):
    """Unpickles an object and hands it back via callback."""

    def __init__(
        self, callback: Callable[[Any], None], checksum: Optional[str]
    ) -> None:
        self._callback = callback
        self._checksum = checksum

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        verify_checksum(buf, self._checksum)
        self._callback(bytes_to_object(buf))

    def get_consuming_cost_bytes(self) -> int:
        return 1 << 20


def _check_readable(entry: Any, what: str) -> None:
    """Refuse entries written by JAX-package features not ported yet,
    rather than return wrong bytes."""
    if getattr(entry, "compression", None) is not None:
        raise NotImplementedError(
            f"{what}: compressed payloads (compression="
            f"{entry.compression!r}) are not yet ported to torchsnapshot_tpu_torch"
        )
    if getattr(entry, "base", None) is not None:
        raise NotImplementedError(
            f"{what}: incremental-snapshot base references are not yet "
            f"ported to torchsnapshot_tpu_torch"
        )
    if getattr(entry, "chunks", None) is not None:
        raise NotImplementedError(
            f"{what}: content-chunked (.chunkstore) payloads are not yet "
            f"ported to torchsnapshot_tpu_torch"
        )


class _ChunkConsumer(BufferConsumer):
    def __init__(self, plan: "ArrayRestorePlan", shard: Shard) -> None:
        self._plan = plan
        self._shard = shard
        self._nbytes = _nbytes(shard.sizes, plan.itemsize)

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        await _in_executor(executor, lambda: self._consume(buf))

    def _consume(self, buf: BufferType) -> None:
        verify_checksum(buf, self._shard.array.checksum)
        if len(buf) != self._nbytes:
            raise RuntimeError(
                f"{self._shard.array.location}: stored object holds "
                f"{len(buf)} bytes, the manifest describes {self._nbytes}"
            )
        self._plan.write_chunk(self._shard, buf)

    def get_consuming_cost_bytes(self) -> int:
        return self._nbytes


class ArrayRestorePlan:
    """Restores one array entry (dense or chunked) into one target.

    The target lies on the template tensor's device (the CPU for a numpy
    or absent template). JAX PRNG-key leaves restore as their raw uint32
    key data: the port has no key type.
    """

    def __init__(self, entry: Entry, template: Any, callback: Callable[[Any], None]):
        if isinstance(entry, ShardedArrayEntry):
            shards = list(entry.shards)
        elif isinstance(entry, ArrayEntry):
            shards = [Shard([0] * len(entry.shape), list(entry.shape), entry)]
        else:
            raise TypeError(f"Not an array entry: {type(entry)}")
        for shard in shards:
            _check_readable(shard.array, shard.array.location)
        shape = list(entry.shape)
        dtype = str_to_torch_dtype(entry.dtype)
        self.itemsize = dtype_itemsize(entry.dtype)
        self._shape = shape
        self._shards = shards
        self._callback = callback
        self._as_numpy = isinstance(template, np.ndarray)
        key_data = entry.prng_impl is not None
        if (
            template is not None
            and hasattr(template, "shape")
            and list(template.shape) != shape
            and not key_data
        ):
            raise RuntimeError(
                f"Cannot restore array of shape {shape} into a template "
                f"of shape {list(template.shape)}."
            )
        if isinstance(template, torch.Tensor):
            if (
                template.dtype == dtype
                and list(template.shape) == shape
                and template.is_contiguous()
            ):
                self._dst = template.detach()
            else:
                self._dst = torch.empty(shape, dtype=dtype, device=template.device)
        else:
            self._dst = torch.empty(shape, dtype=dtype)

    def build_read_reqs(self) -> List[ReadReq]:
        return [
            ReadReq(path=s.array.location, buffer_consumer=_ChunkConsumer(self, s))
            for s in self._shards
        ]

    def write_chunk(self, shard: Shard, buf: BufferType) -> None:
        """Copy one stored chunk's bytes into its box of the target."""
        if not self._shape:
            target: Tuple[slice, ...] = ()
        else:
            ov = compute_overlap(
                shard.offsets, shard.sizes, [0] * len(self._shape), self._shape
            )
            if ov is None:
                return
            target = ov.target_slices
        dst = self._dst
        byte_range = contiguous_byte_range(self._shape, target, self.itemsize)
        if byte_range is not None:
            lo, hi = byte_range
            dst_bytes = dst.reshape(-1).view(torch.uint8)[lo:hi]
            if dst.is_cuda:
                host_to_device(buf, dst_bytes)
            else:
                dst_bytes.numpy()[:] = np.frombuffer(buf, dtype=np.uint8)
            return
        # A chunk that is not one run of the target's layout: land it
        # whole, then scatter it into its box on the target's device.
        chunk = torch.empty(shard.sizes, dtype=dst.dtype, device=dst.device)
        if dst.is_cuda:
            host_to_device(buf, chunk)
            dst[target].copy_(chunk)
            torch.cuda.current_stream(dst.device).synchronize()
        else:
            chunk.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(
                buf, dtype=np.uint8
            )
            dst[target].copy_(chunk)

    def finalize(self) -> None:
        self._callback(self._dst.numpy() if self._as_numpy else self._dst)


def _prepare_array_write(
    arr: Any, logical_path: str, rank: int
) -> Tuple[Entry, List[WriteReq]]:
    dtype_name = dtype_to_str(arr.dtype)
    shape = list(arr.shape)
    itemsize = dtype_itemsize(dtype_name)
    if _nbytes(shape, itemsize) <= MAX_CHUNK_SIZE_BYTES:
        location = get_storage_path(rank, logical_path, replicated=False)
        entry = ArrayEntry(
            location=location,
            serializer=ARRAY_SERIALIZER,
            dtype=dtype_name,
            shape=shape,
            replicated=False,
        )
        return entry, [WriteReq(location, ArrayBufferStager(arr, entry))]
    # Chunk objects live under their own top-level namespace, with the
    # JAX package's names: "chunked/<rank>/<path>__chunk_<i>".
    base = f"chunked/{rank}/{logical_path}"
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
            WriteReq(location, ArrayBufferStager(arr, chunk_entry, chunk_slices=local))
        )
    entry = ShardedArrayEntry(
        dtype=dtype_name, shape=shape, shards=shards, per_rank=True
    )
    return entry, reqs


def prepare_write(
    obj: Any, logical_path: str, rank: int
) -> Tuple[Entry, List[WriteReq]]:
    """Plan the persistence of one leaf value: its manifest entry and
    the write requests that store it."""
    if isinstance(obj, torch.Tensor):
        return _prepare_array_write(obj.detach(), logical_path, rank)
    # numpy scalars subclass Python numbers (np.float64 is a float), so the
    # array check must run before the primitive check.
    if isinstance(obj, (np.generic, np.ndarray)):
        return _prepare_array_write(np.asarray(obj), logical_path, rank)
    if isinstance(obj, _PRIMITIVE_TYPES):
        return PrimitiveEntry.from_value(obj), []
    location = get_storage_path(rank, logical_path, replicated=False)
    entry = ObjectEntry(location=location, serializer=OBJECT_SERIALIZER, replicated=False)
    return entry, [WriteReq(location, ObjectBufferStager(obj, entry))]


def prepare_read(
    entry: Entry, template: Any, callback: Callable[[Any], None]
) -> Tuple[List[ReadReq], List[Callable[[], None]]]:
    """Plan the restore of one leaf value into ``template``'s placement:
    read requests plus finalizers to run after all reads complete."""
    if isinstance(entry, PrimitiveEntry):
        callback(entry.get_value())
        return [], []
    if isinstance(entry, ObjectEntry):
        _check_readable(entry, entry.location)
        consumer = ObjectBufferConsumer(callback, checksum=entry.checksum)
        return [ReadReq(path=entry.location, buffer_consumer=consumer)], []
    if isinstance(entry, (ArrayEntry, ShardedArrayEntry)):
        plan = ArrayRestorePlan(entry, template, callback)
        return plan.build_read_reqs(), [plan.finalize]
    raise TypeError(f"Cannot prepare read for entry type {type(entry)}")
