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
payload must be a cut of the value at take time. Restore routes every
array entry through an :class:`ArrayRestorePlan` that fills one target
box: the whole array for a tensor template, the local box for a DTensor
template. It reads only the stored objects that overlap the box, and of
each only the byte range the box needs where that range is one run of
the object. The target is the template tensor itself (its local tensor)
when its device, dtype, shape and layout match (the restore then holds
one copy of the state on the card), a new tensor on the template's
device otherwise.
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
from .resharding import Overlap, compute_overlap, contiguous_byte_range, shard_box, subdivide
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


class _RegionConsumer(BufferConsumer):
    """Copies one stored object's overlap with the target box into the
    target. A whole-object read carries the object (its checksum is
    verified); a ranged read carries exactly the overlap's bytes, one
    run of the object, which no stored checksum covers."""

    def __init__(
        self,
        plan: "ArrayRestorePlan",
        shard: Shard,
        overlap: Overlap,
        byte_range: Optional[Tuple[int, int]],
    ) -> None:
        self._plan = plan
        self._shard = shard
        self._overlap = overlap
        self._byte_range = byte_range
        if byte_range is None:
            self._nbytes = _nbytes(shard.sizes, plan.itemsize)
        else:
            self._nbytes = byte_range[1] - byte_range[0]

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        await _in_executor(executor, lambda: self._consume(buf))

    def _consume(self, buf: BufferType) -> None:
        if self._byte_range is None:
            verify_checksum(buf, self._shard.array.checksum)
        if len(buf) != self._nbytes:
            raise RuntimeError(
                f"{self._shard.array.location}: read {len(buf)} bytes where "
                f"the manifest describes {self._nbytes}"
            )
        ov = self._overlap
        if self._byte_range is None:
            self._plan.write_region(buf, list(self._shard.sizes), ov.chunk_slices, ov.target_slices)
        else:
            whole = tuple(slice(0, n) for n in ov.sizes)
            self._plan.write_region(buf, list(ov.sizes), whole, ov.target_slices)

    def get_consuming_cost_bytes(self) -> int:
        return self._nbytes


class ArrayRestorePlan:
    """Restores one array entry (dense or chunked or sharded) into one
    target box.

    A tensor (or numpy, or absent) template takes the whole array, on
    the template's device (the CPU for numpy or none). A DTensor template
    takes its local box (:func:`dtensor_box`) and the result is a DTensor
    with the template's mesh and placements. JAX PRNG-key leaves restore
    as their raw uint32 key data: the port has no key type.
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
        self._shards = shards
        self._callback = callback
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
        self._box_offsets, self._box_sizes = box
        if (
            isinstance(local, torch.Tensor)
            and local.dtype == dtype
            and list(local.shape) == self._box_sizes
            and local.is_contiguous()
        ):
            self._dst = local.detach()
        elif isinstance(local, torch.Tensor):
            self._dst = torch.empty(self._box_sizes, dtype=dtype, device=local.device)
        else:
            self._dst = torch.empty(self._box_sizes, dtype=dtype)

    def build_read_reqs(self) -> List[ReadReq]:
        """One read per stored object that overlaps the box: a ranged
        read where the overlap is one run of the object and not all of
        it, else the whole object."""
        reqs = []
        for shard in self._shards:
            ov = compute_overlap(
                shard.offsets, shard.sizes, self._box_offsets, self._box_sizes
            )
            if ov is None:
                continue
            rng = contiguous_byte_range(shard.sizes, ov.chunk_slices, self.itemsize)
            if rng is not None and rng == (0, _nbytes(shard.sizes, self.itemsize)):
                rng = None
            reqs.append(
                ReadReq(
                    path=shard.array.location,
                    buffer_consumer=_RegionConsumer(self, shard, ov, rng),
                    byte_range=rng,
                )
            )
        return reqs

    def write_region(
        self,
        buf: BufferType,
        src_shape: List[int],
        src_slices: Tuple[slice, ...],
        target_slices: Tuple[slice, ...],
    ) -> None:
        """Copy box ``src_slices`` of the C-order array ``buf`` (of shape
        ``src_shape``) into box ``target_slices`` of the target."""
        dst = self._dst
        src_whole = all(
            sl.start == 0 and sl.stop == n for sl, n in zip(src_slices, src_shape)
        )
        byte_range = contiguous_byte_range(self._box_sizes, target_slices, self.itemsize)
        if src_whole and byte_range is not None:
            lo, hi = byte_range
            dst_bytes = dst.reshape(-1).view(torch.uint8)[lo:hi]
            if dst.is_cuda:
                host_to_device(buf, dst_bytes)
            else:
                dst_bytes.numpy()[:] = np.frombuffer(buf, dtype=np.uint8)
            return
        # A box that is not one run of the target's layout: land the
        # source whole on the target's device, then copy its box into
        # the target there (on the card: no gather on the host).
        staged = torch.empty(src_shape, dtype=dst.dtype, device=dst.device)
        if dst.is_cuda:
            host_to_device(buf, staged)
            dst[target_slices].copy_(staged[src_slices])
            torch.cuda.current_stream(dst.device).synchronize()
        else:
            staged.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(
                buf, dtype=np.uint8
            )
            dst[target_slices].copy_(staged[src_slices])

    def finalize(self) -> None:
        out = self._dst
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
    arr: Any, logical_path: str, rank: int, replicated: bool
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
        return entry, [WriteReq(location, ArrayBufferStager(arr, entry))]
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
            WriteReq(location, ArrayBufferStager(arr, chunk_entry, chunk_slices=local))
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
    dt: Any, logical_path: str
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
            stager = ArrayBufferStager(local, entry, chunk_slices=chunk_slices)
            reqs.append(WriteReq(location, stager))
    return ShardedArrayEntry(dtype=dtype_name, shape=global_shape, shards=shards), reqs


def prepare_write(
    obj: Any, logical_path: str, rank: int, replicated: bool = False
) -> Tuple[Entry, List[WriteReq]]:
    """Plan the persistence of one leaf value: its manifest entry and
    the write requests this rank is responsible for. For replicated
    values the caller drops the requests on ranks that do not own the
    write; a sharded DTensor is never replicated (its own writer rule
    applies)."""
    if is_partitioned(obj):
        return _prepare_sharded_array_write(obj, logical_path)
    if is_dtensor(obj):
        obj = obj.to_local()
    if isinstance(obj, torch.Tensor):
        return _prepare_array_write(obj.detach(), logical_path, rank, replicated)
    # numpy scalars subclass Python numbers (np.float64 is a float), so the
    # array check must run before the primitive check.
    if isinstance(obj, (np.generic, np.ndarray)):
        return _prepare_array_write(np.asarray(obj), logical_path, rank, replicated)
    if isinstance(obj, _PRIMITIVE_TYPES):
        return PrimitiveEntry.from_value(obj, replicated=replicated), []
    location = get_storage_path(rank, logical_path, replicated)
    entry = ObjectEntry(location=location, serializer=OBJECT_SERIALIZER, replicated=replicated)
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
