"""The content-addressed chunk store shared by a run's takes, in the JAX
package's format.

``Snapshot.take(..., chunks=True)`` (or ``TPUSNAPSHOT_CHUNKS=1``):

- each array payload of at least ``TPUSNAPSHOT_CHUNK_MIN_BYTES`` (64 KiB)
  is split into ``TPUSNAPSHOT_CHUNK_BYTES`` chunks (4 MiB) and every
  chunk is fingerprinted in one pass, on the card for a CUDA tensor (K5
  of ``ops/fingerprint.py``), before any byte crosses to the host;
- a chunk is written only when the run's store
  (``<parent>/.chunkstore/objects/<hh>/<key>``) does not hold it yet: the
  content key is ``<fingerprint>-<nbytes>-<codec>``, so consecutive takes
  share unchanged chunks even where a leaf is only partly changed, and a
  missing chunk's bytes alone are sliced on the card and copied over;
- an optional codec (``codecs.py``) runs between serialization and
  storage, recorded per chunk.

The entry keeps its natural ``location`` (never written), gains its
``chunks`` records, and its ``base`` index names the store in
``base_paths`` (``"rel:.chunkstore"``), so restore reads the chunks
through ``RefRouterPlugin``.

Garbage collection derives reference counts, as the JAX package does:

- a take drops an intent marker (``intents/…``) before it lists the
  store, and delete/reconcile free no chunk while a young intent exists;
- before the metadata commit, rank 0 writes a ref document
  (``refs/<sha1(path)>``) listing every chunk key of the merged
  manifest, so a committed manifest always has one;
- ``Snapshot.delete`` removes its own ref document, then frees the
  chunks no other live ref (a committed snapshot's, or one younger than
  ``TPUSNAPSHOT_SWEEP_MIN_AGE_S``) lists; an unreadable ref or metadata
  frees nothing (fails closed);
- ``CheckpointManager.reconcile`` sweeps stale intents, stale refs and
  unreferenced chunks, under the same age guard.
"""

import asyncio
import hashlib
import json
import logging
import os
import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import codecs, telemetry, tracing
from .io_preparer import ArrayBufferStager, _in_executor
from .io_types import IOReq, StoragePlugin, WriteReq, io_payload, is_not_found_error
from .manifest import ArrayEntry, Manifest, ShardedArrayEntry, SnapshotMetadata
from .ops.fingerprint import flat_bytes
from .ops.transfer import device_to_host
from .serialization import compute_checksum, verify_checksum
from .storage_plugin import _parent_url, encode_base_ref, resolve_base_ref, url_to_storage_plugin
from .telemetry import consume_profile as _cprof
from .telemetry import metrics as _metric_names
from .utils.env import env_float, env_int

logger = logging.getLogger(__name__)

STORE_DIRNAME = ".chunkstore"
OBJECTS_PREFIX = "objects/"
REFS_PREFIX = "refs/"
INTENTS_PREFIX = "intents/"

CHUNKS_ENV_VAR = "TPUSNAPSHOT_CHUNKS"
CHUNK_BYTES_ENV_VAR = "TPUSNAPSHOT_CHUNK_BYTES"
CHUNK_MIN_BYTES_ENV_VAR = "TPUSNAPSHOT_CHUNK_MIN_BYTES"
_DEFAULT_CHUNK_BYTES = 4 << 20
# Smaller leaves stay on the plain write path: a scalar buys no dedup
# worth a store round trip and a manifest record.
_DEFAULT_CHUNK_MIN_BYTES = 1 << 16

# Content-addressed object path: "objects/<hh>/xs128:<32hex>-<n>-<codec>"
_KEY_RE = re.compile(
    r"(?:^|/)objects/[0-9a-f]{2}/(xs128:[0-9a-f]{32}-\d+-[a-z0-9]+)$"
)

# Write-path prefix the take's StoreRouterPlugin sends to the store.
ROUTE_PREFIX = "@chunkstore/"


def chunks_enabled_default() -> bool:
    return env_int(CHUNKS_ENV_VAR, 0) != 0


def chunk_bytes() -> int:
    raw = env_int(CHUNK_BYTES_ENV_VAR, _DEFAULT_CHUNK_BYTES)
    # Word-aligned, so a chunk's fingerprint is that of its byte slice.
    return max(4, raw - (raw % 4))


def chunk_min_bytes() -> int:
    return env_int(CHUNK_MIN_BYTES_ENV_VAR, _DEFAULT_CHUNK_MIN_BYTES)


def store_url_for(snapshot_path: str) -> Optional[str]:
    """The run's store: a ``.chunkstore`` sibling of the snapshot (at the
    manager's base in its ``step-<N>`` layout). None when the path has no
    parent: chunking is then off."""
    parent = _parent_url(snapshot_path.rstrip("/"))
    return None if parent is None else f"{parent}/{STORE_DIRNAME}"


def chunk_key(fingerprint: str, nbytes: int, codec: Optional[str]) -> str:
    """Content key: fingerprint, logical length and codec. The codec keeps
    an int8 object from ever serving a leaf that did not opt into it."""
    return f"{fingerprint}-{nbytes}-{codec or 'raw'}"


def chunk_object_path(key: str) -> str:
    return f"{OBJECTS_PREFIX}{key.split(':', 1)[1][:2]}/{key}"


def content_address_of(path: str) -> Optional[str]:
    """The content key embedded in a chunk object's storage path, or None
    for any other path. The read plane keys its content cache by it: a
    retake of a mostly unchanged model references the same keys, so the
    cache stays warm across manifests."""
    m = _KEY_RE.search(path)
    return m.group(1) if m else None


def ref_doc_name(snapshot_path: str) -> str:
    return hashlib.sha1(snapshot_path.rstrip("/").encode()).hexdigest()[:16]


def _min_age_s() -> float:
    return env_float("TPUSNAPSHOT_SWEEP_MIN_AGE_S", 3600.0)


@dataclass
class ChunkStats:
    """One rank's accounting of a take's chunk pass; ``note_stored`` runs
    on staging threads."""

    chunk_hits: int = 0
    chunk_misses: int = 0
    hit_bytes: int = 0  # logical bytes skipped by dedup
    logical_bytes: int = 0  # logical bytes of every chunked leaf
    written_logical_bytes: int = 0  # logical bytes of missed chunks
    stored_bytes: int = 0  # bytes written, after the codec
    leaf_clean_bytes: int = 0  # bytes of leaves whose chunks all hit
    chunked_leaves: int = 0
    codec_in_bytes: int = 0  # logical bytes through a non-identity codec
    codec_out_bytes: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def note_stored(self, logical: int, stored: int, codec: Optional[str]) -> None:
        with self._lock:
            self.stored_bytes += stored
            if codec is not None:
                self.codec_in_bytes += logical
                self.codec_out_bytes += stored
        telemetry.counter(_metric_names.CHUNKSTORE_BYTES, result="stored").inc(stored)
        if codec is not None:
            telemetry.counter(_metric_names.CODEC_BYTES, dir="in", codec=codec).inc(logical)
            telemetry.counter(_metric_names.CODEC_BYTES, dir="out", codec=codec).inc(stored)

    def fold_into_churn(self, note: Dict[str, Any]) -> None:
        """Merge this pass's numbers into the rank's churn note (the
        flight report's block that the ledger sums across ranks)."""
        with self._lock:
            note.update(
                chunk_hits=self.chunk_hits,
                chunk_misses=self.chunk_misses,
                chunk_hit_bytes=self.hit_bytes,
                chunk_logical_bytes=self.logical_bytes,
                chunk_written_logical_bytes=self.written_logical_bytes,
                chunk_stored_bytes=self.stored_bytes,
                leaf_clean_bytes=self.leaf_clean_bytes,
                codec_in_bytes=self.codec_in_bytes,
                codec_out_bytes=self.codec_out_bytes,
            )


class StoreRouterPlugin(StoragePlugin):
    """Sends ``@chunkstore/…`` paths of a take's write pipeline to the
    store; everything else to the snapshot's plugin. It owns neither
    plugin. (Reads of chunks go through ``RefRouterPlugin``.)"""

    def __init__(self, inner: StoragePlugin, store: StoragePlugin) -> None:
        self._inner = inner
        self._store = store
        self.max_write_concurrency = inner.max_write_concurrency
        self.max_read_concurrency = inner.max_read_concurrency

    def _route(self, path: str) -> Tuple[StoragePlugin, str]:
        if path.startswith(ROUTE_PREFIX):
            return self._store, path[len(ROUTE_PREFIX):]
        return self._inner, path

    async def write(self, io_req: IOReq) -> None:
        plugin, path = self._route(io_req.path)
        if plugin is self._inner:
            await plugin.write(io_req)
        else:
            await plugin.write(IOReq(path=path, data=io_req.data, buf=io_req.buf))

    async def read(self, io_req: IOReq) -> None:
        plugin, path = self._route(io_req.path)
        if plugin is self._inner:
            await plugin.read(io_req)
            return
        routed = IOReq(path=path, buf=io_req.buf, byte_range=io_req.byte_range)
        await plugin.read(routed)
        io_req.data = routed.data

    async def delete(self, path: str) -> None:
        plugin, p = self._route(path)
        await plugin.delete(p)

    def ensure_durable(self) -> None:
        self._store.ensure_durable()
        self._inner.ensure_durable()

    def close(self) -> None:
        pass  # the take's chunk context closes the plugins it borrows


class ChunkStager(ArrayBufferStager):
    """Stages ONE missing content chunk: slices the flat element range of
    the source (on the card for a CUDA tensor, so only the chunk's bytes
    cross), encodes it through the chunk's codec and back-patches the
    stored size and checksum into the record. An ``ArrayBufferStager``,
    so an async take's device clone covers it: every chunk stager of a
    leaf stages from the one clone."""

    def __init__(
        self,
        data: Any,
        elem_range: Tuple[int, int],
        record: Dict[str, Any],
        codec: Optional[str],
        dtype_name: str,
        nbytes: int,
        stats: ChunkStats,
        entry: ArrayEntry,
        ready: Optional[Any] = None,
    ) -> None:
        self._data = data
        self._entry = entry
        self._chunk_slices = None
        self._compression = None
        self._ready = ready
        self._elem_range = elem_range
        self._record = record
        self._codec = codec
        self._dtype_name = dtype_name
        self._nbytes = nbytes
        self._stats = stats
        # (seconds, stored bytes) of the codec stage, which the scheduler
        # reports as its own "encode" op.
        self.encode_stats: Optional[Tuple[float, int]] = None

    async def stage_buffer(self, executor=None):
        # An executor thread's context carries no trace: carry the take's
        # trace id across, so the encode span joins the take.
        tid = tracing.current_trace_id()

        def _stage_adopted():
            with tracing.adopt_trace(tid):
                return self._stage_sync()

        return await _in_executor(executor, _stage_adopted)

    def _stage_sync(self):
        data = self._data
        a, b = self._elem_range
        if isinstance(data, torch.Tensor):
            itemsize = data.element_size()
            part = flat_bytes(data)[a * itemsize : b * itemsize]
            if data.is_cuda:
                payload = memoryview(device_to_host(part, self._ready).numpy())
            else:
                payload = memoryview(part.clone().numpy())  # a consistent cut
        else:
            host = np.ascontiguousarray(np.asarray(data))
            itemsize = host.dtype.itemsize
            payload = memoryview(bytes(host.reshape(-1).view(np.uint8)[a * itemsize : b * itemsize]))
        self._data = None
        logical = len(payload)
        codec = self._codec
        stored: Any = payload
        if codec is not None:
            t0 = time.monotonic()
            try:
                with tracing.span("encode", codec=codec, bytes=logical):
                    stored = codecs.encode(codec, payload, self._dtype_name)
            except codecs.CodecUnsuitable as e:
                # The key and path are fixed already: store identity bytes
                # under them and record no codec; the read path's identity
                # fallback serves them.
                logger.warning(f"codec {codec!r} unsuitable for chunk ({e}); storing identity bytes")
                codec, stored = None, payload
            self.encode_stats = (time.monotonic() - t0, len(stored))
        rec = self._record
        rec["c"] = codec
        rec["sn"] = len(stored)
        rec["cs"] = compute_checksum(stored)
        self._stats.note_stored(logical, len(stored), codec)
        return stored

    @property
    def write_path(self) -> str:
        return ROUTE_PREFIX + chunk_object_path(self._record["k"])


@dataclass
class _ChunkContext:
    store_url: str
    store_plugin: StoragePlugin
    intent_path: Optional[str]
    stats: ChunkStats

    def wrap(self, storage: StoragePlugin) -> StoragePlugin:
        return StoreRouterPlugin(storage, self.store_plugin)

    def cleanup(self) -> None:
        """After the commit or a failure: drop this rank's intent and close
        the store plugin. Best-effort: a left intent ages out."""
        try:
            if self.intent_path is not None:
                asyncio.run(self.store_plugin.delete(self.intent_path))
        except Exception as e:
            if not is_not_found_error(e):
                logger.warning(f"chunkstore intent cleanup failed: {e!r}")
        finally:
            self.intent_path = None
            try:
                self.store_plugin.close()
            except Exception:  # best-effort teardown
                logger.warning("chunkstore plugin close failed", exc_info=True)


def _manifest_logical_paths(manifest: Manifest) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for path, entry in manifest.items():
        if isinstance(entry, ArrayEntry):
            out[id(entry)] = path
        elif isinstance(entry, ShardedArrayEntry):
            for shard in entry.shards:
                out[id(shard.array)] = path
    return out


# Per-dtype proof, once a process, that the card's chunk fingerprints
# equal the host's: chunk keys must verify against fingerprint_host at
# restore. The word view makes them equal by construction, so on the card
# a disagreement, or a kernel that fails to build or launch, raises: the
# take fails rather than hash the leaf on the host. For CPU tensors a
# failed probe sends the dtype's leaves to fingerprint_host_chunked.
_FP_AGREEMENT: Dict[str, bool] = {}


def _device_fp_matches_host(dtype: torch.dtype, device: torch.device) -> bool:
    key = f"{dtype}@{device.type}"
    cached = _FP_AGREEMENT.get(key)
    if cached is not None:
        return cached
    from .fingerprint import fingerprint_device_chunked_async, fingerprint_host_chunked, resolve_chunk_fingerprints

    base = torch.arange(96, device=device)
    host = (base % 3 == 0) if dtype == torch.bool else (base % 251).to(torch.float32).to(dtype)
    probe_bytes = 64  # a multiple of 4, smaller than the payload
    if device.type == "cuda":
        dev = resolve_chunk_fingerprints([fingerprint_device_chunked_async(host, probe_bytes)])[0]
        if isinstance(dev, Exception):
            raise dev
        if dev != fingerprint_host_chunked(host.cpu(), probe_bytes):
            raise RuntimeError(f"K5 disagrees with fingerprint_host_chunked for dtype {dtype} on {device}")
        ok = True
    else:
        try:
            dev = resolve_chunk_fingerprints([fingerprint_device_chunked_async(host, probe_bytes)])[0]
            ok = not isinstance(dev, Exception) and dev == fingerprint_host_chunked(host, probe_bytes)
        # Probe failure = no proven agreement: degrade to host hashing.
        except Exception:  # snapcheck: disable=swallowed-exception -- agreement probe; degrades to host hashing
            ok = False
        if not ok:
            logger.warning(
                f"plain and host chunk fingerprints disagree for dtype {dtype}; "
                f"such leaves are fingerprinted with fingerprint_host_chunked"
            )
    _FP_AGREEMENT[key] = ok
    return ok


def _chunk_grid(total_elems: int, itemsize: int, target_bytes: int) -> Tuple[int, int]:
    """(elements a chunk, chunks), each chunk's byte length a multiple of 4."""
    align = 4 // int(np.gcd(itemsize, 4)) if itemsize < 4 else 1
    elems = int(max(align, (target_bytes // itemsize) // align * align))
    return elems, int(max(1, -(-total_elems // elems)))


def apply_chunkstore(
    manifest: Manifest,
    write_reqs: List[Any],
    *,
    rank: int,
    own_path: str,
    base_paths: List[str],
    codec_spec: Any = None,
    stats: Optional[ChunkStats] = None,
) -> Optional[_ChunkContext]:
    """Rewrite array write requests into content-chunk writes, skipping
    every chunk the store already holds. Mutates the manifest's entries
    and ``write_reqs``, and appends the store to ``base_paths`` (a pure
    function of the path: every rank derives the same list). Returns the
    context the caller must ``cleanup()`` after the commit or a failure,
    or None when chunking cannot run here (the take proceeds unchunked)."""
    stats = stats if stats is not None else ChunkStats()
    # A bad codec spec fails the take before any store side effect.
    plan = codecs.resolve_codec_plan(codec_spec)
    store_url = store_url_for(own_path)
    if store_url is None:
        logger.warning(
            f"chunk dedup disabled: snapshot path {own_path!r} has no parent "
            f"directory to hold the shared {STORE_DIRNAME} store"
        )
        return None
    # Before any fallible store IO, on every rank: a rank whose store is
    # unusable writes unchunked and leaves the entry inert.
    store_ref = encode_base_ref(store_url, own_path)
    if store_ref not in base_paths:
        base_paths.append(store_ref)
    store_idx = base_paths.index(store_ref)
    store_plugin = url_to_storage_plugin(store_url)
    intent_path = None
    try:
        # The intent goes before the listing: delete/reconcile must not
        # free a chunk between our "present" and our ref document.
        intent_path = f"{INTENTS_PREFIX}{uuid.uuid4().hex[:16]}-r{rank}"
        intent = IOReq(path=intent_path)
        intent.buf.write(json.dumps({"pid": os.getpid(), "rank": rank}).encode())
        asyncio.run(store_plugin.write(intent))
        known = asyncio.run(store_plugin.list_prefix(OBJECTS_PREFIX))
        if known is None:
            logger.warning(
                f"chunk dedup disabled: the backend of {store_url!r} cannot "
                f"enumerate objects (GC would be impossible)"
            )
            asyncio.run(store_plugin.delete(intent_path))
            store_plugin.close()
            return None
    except Exception:
        # A broken store must not fail the checkpoint.
        logger.warning(f"chunk dedup disabled: store {store_url!r} unusable", exc_info=True)
        try:
            store_plugin.close()
        # Best-effort teardown of a plugin already proven broken.
        except Exception:  # snapcheck: disable=swallowed-exception -- teardown of failed plugin
            pass
        return None
    ctx = _ChunkContext(store_url, store_plugin, intent_path, stats)
    try:
        _apply_chunkstore_body(
            manifest, write_reqs, store_idx=store_idx,
            index={p.rsplit("/", 1)[-1] for p in known}, plan=plan, stats=stats,
        )
    except BaseException:
        ctx.cleanup()
        raise
    logger.info(
        f"chunkstore: rank {rank} deduplicated {stats.chunk_hits} chunk(s) "
        f"(~{stats.hit_bytes / (1 << 20):.1f} MiB), writing {stats.chunk_misses}"
    )
    return ctx


def _finite(data: Any) -> bool:
    try:
        if isinstance(data, torch.Tensor):
            return bool(torch.isfinite(data).all())
        return bool(np.isfinite(np.asarray(data)).all())
    except (TypeError, RuntimeError):  # a dtype isfinite does not take
        return False


def _apply_chunkstore_body(
    manifest: Manifest,
    write_reqs: List[Any],
    *,
    store_idx: int,
    index: Set[str],
    plan: codecs.CodecPlan,
    stats: ChunkStats,
) -> None:
    from .fingerprint import (
        fingerprint_device_chunked_async,
        fingerprint_device_chunked_many_async,
        fingerprint_host_chunked,
        resolve_chunk_fingerprints,
    )

    paths_by_entry = _manifest_logical_paths(manifest)
    target = chunk_bytes()
    min_bytes = chunk_min_bytes()
    # Pass 1: pick the eligible requests and dispatch every fingerprint;
    # the leaves on the card go in one K5 batch, one launch per device.
    selected = []
    on_card: List[Tuple[int, torch.Tensor, int]] = []  # (index in selected, words, chunk bytes)
    for wr in write_reqs:
        stager = wr.buffer_stager
        if not isinstance(stager, ArrayBufferStager) or isinstance(stager, ChunkStager):
            continue
        entry, data = stager._entry, stager._data
        if (
            data is None
            or not isinstance(entry, ArrayEntry)
            or entry.serializer != "raw"
            or stager._chunk_slices is not None  # a sub-box: the plain path
            or stager._nbytes < min_bytes
        ):
            continue
        ready = stager._ready
        if isinstance(data, torch.Tensor):
            itemsize = data.element_size()
            if not data.is_contiguous():
                # One on-card copy, on the current stream: the cut.
                data = data.contiguous()
                if data.is_cuda:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(data.device))
        else:
            itemsize = np.dtype(np.uint8 if data.dtype == np.bool_ else data.dtype).itemsize
        elems, n_chunks = _chunk_grid(stager._nbytes // itemsize, itemsize, target)
        cbytes = elems * itemsize
        lpath = paths_by_entry.get(id(entry), "")
        if isinstance(data, torch.Tensor) and data.is_cuda:
            # K5 reads the stored bytes, so a complex leaf goes as its real
            # view. A failed build, launch or probe fails the take.
            words = torch.view_as_real(data) if data.dtype.is_complex else data
            _device_fp_matches_host(words.dtype, words.device)
            on_card.append((len(selected), words, cbytes))
            selected.append((wr, entry, data, ready, lpath, itemsize, elems, n_chunks, None))
            continue
        try:
            if isinstance(data, torch.Tensor) and _device_fp_matches_host(data.dtype, data.device):
                fp: Any = fingerprint_device_chunked_async(data, cbytes)
            else:
                fp = fingerprint_host_chunked(data, cbytes)
        except Exception as e:
            logger.warning(
                f"chunk fingerprint unavailable for {lpath!r} ({e!r}); the leaf "
                f"stays on the plain write path"
            )
            continue
        selected.append((wr, entry, data, ready, lpath, itemsize, elems, n_chunks, fp))
    if on_card:
        results = fingerprint_device_chunked_many_async([w for _, w, _ in on_card], [cb for _, _, cb in on_card])
        for (i, _, _), r in zip(on_card, results):
            selected[i] = selected[i][:-1] + (r,)
    handles = [s[-1] for s in selected if not isinstance(s[-1], list)]
    resolved = iter(resolve_chunk_fingerprints(handles))

    # Pass 2: chunk records and the write requests of missing chunks.
    replaced: Dict[int, List[Any]] = {}
    scheduled: Set[str] = set()  # keys already being written this take
    for wr, entry, data, ready, lpath, itemsize, elems, n_chunks, fp in selected:
        fps = fp if isinstance(fp, list) else next(resolved)
        if isinstance(fps, Exception):
            if isinstance(data, torch.Tensor) and data.is_cuda:
                raise fps
            logger.warning(f"chunk fingerprint failed for {lpath!r} ({fps!r}); plain write path")
            continue
        codec = plan.codec_for(lpath, dtype_name=entry.dtype, prng_impl=entry.prng_impl)
        if codecs.is_lossy(codec) and not _finite(data):
            # The keys are fixed here, so an unquantizable leaf is stored
            # uncoded as a whole, now.
            logger.warning(
                f"codec {codec!r} matched {lpath!r} but the payload is not "
                f"finite-valued; storing without quantization"
            )
            codec = None
        nbytes = wr.buffer_stager._nbytes
        total_elems = nbytes // itemsize
        records: List[Dict[str, Any]] = []
        new_reqs: List[Any] = []
        leaf_hit_bytes = 0
        for i in range(n_chunks):
            a = i * elems
            b = min(total_elems, a + elems)
            logical = (b - a) * itemsize
            key = chunk_key(fps[i], logical, codec)
            rec: Dict[str, Any] = {"k": key, "n": logical, "c": codec}
            records.append(rec)
            if key in index or key in scheduled:
                # A hit: the object verifies against its key at restore.
                stats.chunk_hits += 1
                stats.hit_bytes += logical
                leaf_hit_bytes += logical
                telemetry.counter(_metric_names.CHUNKSTORE_CHUNKS, result="hit").inc()
                telemetry.counter(_metric_names.CHUNKSTORE_BYTES, result="hit").inc(logical)
                continue
            rec["sn"] = rec["cs"] = None
            stats.chunk_misses += 1
            stats.written_logical_bytes += logical
            scheduled.add(key)
            stager = ChunkStager(data, (a, b), rec, codec, entry.dtype, logical, stats, entry, ready)
            new_reqs.append(WriteReq(path=stager.write_path, buffer_stager=stager))
            telemetry.counter(_metric_names.CHUNKSTORE_CHUNKS, result="miss").inc()
        stats.logical_bytes += nbytes
        stats.chunked_leaves += 1
        if leaf_hit_bytes == nbytes:
            stats.leaf_clean_bytes += nbytes
        entry.chunks = records
        entry.base = store_idx
        entry.checksum = None
        entry.compression = None
        replaced[id(wr)] = new_reqs
    if replaced:
        out: List[Any] = []
        for wr in write_reqs:
            out.extend(replaced.get(id(wr), [wr]))
        write_reqs[:] = out


def decode_and_verify_chunk(
    rec: Dict[str, Any],
    dtype_name: str,
    stored: Any,
    profile: Any = None,
    out: Optional[memoryview] = None,
) -> Optional[bytes]:
    """Decode one stored content chunk and verify it, whichever take
    wrote it: the stored size and crc where this manifest recorded them
    (a mismatch there is only noted: a concurrent writer of the same key
    may have encoded it otherwise), then the content itself — lossless
    chunks must fingerprint back to their key, lossy frames check their
    own crc. A chunk whose codec fails to decode but whose stored length
    is the logical length is read as identity bytes (the stager's
    unsuitable-payload degrade); the fingerprint still gates them.

    With ``out`` (exactly ``n`` writable bytes), identity chunks verify
    on the stored view and are copied into ``out`` once (returns None);
    otherwise the decoded bytes are returned."""
    from .fingerprint import fingerprint_host

    key = rec["k"]
    logical_n = int(rec["n"])
    codec = rec.get("c")
    stored_n = rec.get("sn")
    stale_note = None
    if stored_n is not None and len(stored) != int(stored_n):
        stale_note = f"stored {len(stored)} bytes vs recorded {stored_n}"
    else:
        try:
            with _cprof.substep(profile, "verify", len(stored)):
                verify_checksum(stored, rec.get("cs"))
        except RuntimeError as e:
            stale_note = str(e)
    note = f" (recorded-bytes mismatch: {stale_note})" if stale_note else ""
    expected_fp = key.rsplit("-", 2)[0]

    def check_content(logical: Any) -> None:
        if len(logical) != logical_n:
            raise RuntimeError(
                f"content chunk {key}: decoded {len(logical)} bytes, expected {logical_n}{note}"
            )
        with _cprof.substep(profile, "verify", logical_n):
            actual = fingerprint_host(logical)
        if actual != expected_fp:
            raise RuntimeError(
                f"content chunk {key}: stored bytes decode to content fingerprinting "
                f"as {actual} — the store object is corrupt or mis-addressed{note}"
            )

    if out is not None and codec in (None, "identity"):
        check_content(stored)
        with _cprof.substep(profile, "reassemble", logical_n):
            out[:logical_n] = stored
        logical = None
    else:
        try:
            with _cprof.substep(profile, "decode", len(stored)):
                logical = codecs.decode(codec, stored, dtype_name)
        except Exception:
            if codec is None or len(stored) != logical_n:
                raise
            logger.warning(
                f"content chunk {key}: codec {codec!r} decode failed but the stored "
                f"length matches the logical one; reading it as identity"
            )
            logical, codec = bytes(stored), None
        if codecs.is_lossy(codec):
            if len(logical) != logical_n:
                raise RuntimeError(
                    f"content chunk {key}: decoded {len(logical)} bytes, expected {logical_n}{note}"
                )
        else:
            check_content(logical)
    if stale_note:
        logger.warning(
            f"content chunk {key}: recorded stored size/crc do not match the "
            f"object ({stale_note}) but its content verified; likely a concurrent "
            f"same-key writer with another encoder"
        )
    return logical


def entry_is_lossy(entry: Any) -> bool:
    """Whether any chunk record of an entry used a lossy codec (its
    restored bytes then differ from its recorded fingerprint)."""
    return any(codecs.is_lossy(rec.get("c")) for rec in getattr(entry, "chunks", None) or [])


def chunk_keys_of(manifest: Manifest) -> Set[str]:
    keys: Set[str] = set()
    for entry in manifest.values():
        if isinstance(entry, ArrayEntry) and entry.chunks:
            keys.update(rec["k"] for rec in entry.chunks)
        elif isinstance(entry, ShardedArrayEntry):
            for shard in entry.shards:
                if shard.array.chunks:
                    keys.update(rec["k"] for rec in shard.array.chunks)
    return keys


def manifest_has_chunks(manifest: Manifest) -> bool:
    return bool(chunk_keys_of(manifest))


async def awrite_ref_for(snapshot_path: str, metadata: SnapshotMetadata) -> None:
    """Durably record the merged manifest's chunk keys before the metadata
    commit (rank 0): a committed manifest without a ref document could be
    freed by GC. A no-op for a manifest without chunks."""
    keys = chunk_keys_of(metadata.manifest)
    if not keys:
        return
    store_url = store_url_for(snapshot_path)
    if store_url is None:
        raise RuntimeError(
            f"the manifest has chunk entries but {snapshot_path!r} has no parent "
            f"directory for the store"
        )
    storage = url_to_storage_plugin(store_url)
    try:
        doc = IOReq(path=REFS_PREFIX + ref_doc_name(snapshot_path))
        doc.buf.write(
            json.dumps(
                {
                    "path": encode_base_ref(snapshot_path, store_url),
                    "take_id": metadata.take_id,
                    "chunks": sorted(keys),
                }
            ).encode()
        )
        await storage.write(doc)
    finally:
        storage.close()


async def _aread_ref_docs(storage: StoragePlugin) -> List[Tuple[str, Optional[Dict[str, Any]]]]:
    """[(marker path, parsed document or None when unreadable)]."""
    out: List[Tuple[str, Optional[Dict[str, Any]]]] = []
    for p in await storage.list_prefix(REFS_PREFIX) or []:
        try:
            io_req = IOReq(path=p)
            await storage.read(io_req)
            doc = json.loads(bytes(io_payload(io_req)).decode())
            if not isinstance(doc.get("chunks"), list):
                raise ValueError("malformed ref doc")
            out.append((p, doc))
        except Exception as e:
            logger.warning(f"unreadable chunk-ref doc {p}: {e!r}")
            out.append((p, None))
    return out


async def _alive_ref_keys(
    storage: StoragePlugin,
    store_url: str,
    min_age_s: float,
    exclude: Optional[str] = None,
    stale_out: Optional[List[str]] = None,
) -> Optional[Set[str]]:
    """Chunk keys protected by live ref documents (a committed snapshot's,
    or a young one that may be a take in flight), without the marker
    ``exclude``. None when any document or referencer's metadata is
    unreadable: freeing would be unsafe. Stale documents go to
    ``stale_out``."""
    from .snapshot import _aread_metadata_at

    live: Set[str] = set()
    for marker_path, doc in await _aread_ref_docs(storage):
        if marker_path == exclude:
            continue
        if doc is None:
            return None
        try:
            snap_url = resolve_base_ref(doc["path"], store_url)
        except (KeyError, TypeError, ValueError) as e:
            logger.warning(f"malformed chunk-ref doc {marker_path}: {e!r}; freeing nothing this pass")
            return None
        try:
            committed_keys = chunk_keys_of((await _aread_metadata_at(snap_url)).manifest)
        except Exception as e:
            # Only "not found" means uncommitted; anything else may hide
            # a committed snapshot.
            if not is_not_found_error(e):
                logger.warning(
                    f"chunk GC: cannot tell whether {snap_url!r} is committed ({e!r}); "
                    f"freeing nothing this pass"
                )
                return None
            committed_keys = set()
        if committed_keys:
            # The committed manifest's keys, and the document's (a re-take
            # to the same path rewrites the document before its commit).
            live.update(committed_keys)
            live.update(doc["chunks"])
            continue
        if min_age_s > 0:
            try:
                age = await storage.object_age_s(marker_path)
            # Unknown age fails CLOSED (treated as live) just below.
            except Exception:  # snapcheck: disable=swallowed-exception -- fails closed
                age = None
            if age is None or age < min_age_s:
                live.update(doc["chunks"])
                continue
        if stale_out is not None:
            stale_out.append(marker_path)
    return live


async def _ayoung_intent_present(
    storage: StoragePlugin, min_age_s: float, stale_out: Optional[List[str]] = None
) -> bool:
    """Whether an intent marker may belong to a take in flight. With the
    age guard off (0) none is young."""
    young = False
    for p in await storage.list_prefix(INTENTS_PREFIX) or []:
        if min_age_s <= 0:
            if stale_out is not None:
                stale_out.append(p)
            continue
        try:
            age = await storage.object_age_s(p)
        # Unknown age fails CLOSED: treat as an in-flight take.
        except Exception:  # snapcheck: disable=swallowed-exception -- fails closed
            age = None
        if age is None or age < min_age_s:
            young = True
        elif stale_out is not None:
            stale_out.append(p)
    return young


async def _adelete_missing_ok(storage: StoragePlugin, path: str) -> None:
    try:
        await storage.delete(path)
    except Exception as e:
        if not is_not_found_error(e):
            raise


def gc_snapshot_chunks(snapshot_path: str, metadata: SnapshotMetadata) -> Dict[str, int]:
    """``Snapshot.delete``'s chunk GC, after the metadata (the commit
    point) is gone: (1) delete the own ref document — the refcount
    decrement; (2) free nothing while a young intent exists; (3) free
    the own keys that no other live ref lists. A crash at any step only
    leaks; ``reconcile`` re-drives it."""
    out = {"freed": 0, "kept": 0, "skipped": 0}
    own_keys = chunk_keys_of(metadata.manifest)
    store_url = store_url_for(snapshot_path)
    if not own_keys or store_url is None:
        return out
    min_age_s = _min_age_s()
    storage = url_to_storage_plugin(store_url)

    async def _run() -> None:
        own_marker = REFS_PREFIX + ref_doc_name(snapshot_path)
        await _adelete_missing_ok(storage, own_marker)
        if await _ayoung_intent_present(storage, min_age_s):
            logger.info(f"chunk GC for {snapshot_path}: a take appears in flight; deferring")
            out["skipped"] = len(own_keys)
            return
        live = await _alive_ref_keys(storage, store_url, min_age_s, exclude=own_marker)
        if live is None:
            logger.warning(f"chunk GC for {snapshot_path}: unreadable ref doc(s); freeing nothing")
            out["skipped"] = len(own_keys)
            return
        doomed = sorted(own_keys - live)
        out["kept"] = len(own_keys) - len(doomed)
        # Again right before freeing: a take that began since may have
        # observed these chunks as present.
        if doomed and await _ayoung_intent_present(storage, min_age_s):
            out["skipped"] = len(doomed)
            return
        for key in doomed:
            await _adelete_missing_ok(storage, chunk_object_path(key))
            out["freed"] += 1
            telemetry.counter(_metric_names.CHUNKSTORE_GC, action="freed").inc()

    try:
        asyncio.run(_run())
    finally:
        storage.close()
    return out


def reconcile_store(base_url: str) -> Dict[str, int]:
    """Reconcile's janitor of ``<base_url>/.chunkstore``: stale intents,
    stale ref documents (uncommitted and aged) and chunks no live
    committed manifest references, each under the age guard."""
    out = {"freed": 0, "kept": 0, "stale_refs": 0, "stale_intents": 0}
    store_url = f"{base_url.rstrip('/')}/{STORE_DIRNAME}"
    min_age_s = _min_age_s()
    storage = url_to_storage_plugin(store_url)

    async def _sweep(paths: List[str], what: str) -> int:
        n = 0
        for p in paths:
            try:
                await _adelete_missing_ok(storage, p)
                n += 1
            except Exception as e:
                logger.warning(f"{what} sweep of {p} failed: {e!r}")
        return n

    async def _run() -> None:
        objs = await storage.list_prefix(OBJECTS_PREFIX) or []
        if not objs and not await storage.list_prefix(REFS_PREFIX) and not await storage.list_prefix(INTENTS_PREFIX):
            return
        stale_intents: List[str] = []
        if await _ayoung_intent_present(storage, min_age_s, stale_out=stale_intents):
            logger.info(f"chunkstore reconcile at {store_url}: a take is in flight; deferring")
            return
        out["stale_intents"] = await _sweep(stale_intents, "intent")
        stale_refs: List[str] = []
        live = await _alive_ref_keys(storage, store_url, min_age_s, stale_out=stale_refs)
        if live is None:
            logger.warning(f"chunkstore reconcile at {store_url}: unreadable ref doc(s); freeing nothing")
            return
        out["stale_refs"] = await _sweep(stale_refs, "ref")
        doomed = [o for o in objs if o.rsplit("/", 1)[-1] not in live]
        out["kept"] += len(objs) - len(doomed)
        if doomed and await _ayoung_intent_present(storage, min_age_s):
            return
        for obj in doomed:
            if min_age_s > 0:
                try:
                    age = await storage.object_age_s(obj)
                except Exception as e:
                    logger.warning(f"sparing chunk {obj} (age probe failed: {e!r})")
                    continue
                if age is None or age < min_age_s:
                    out["kept"] += 1
                    continue
            try:
                await _adelete_missing_ok(storage, obj)
                out["freed"] += 1
                telemetry.counter(_metric_names.CHUNKSTORE_GC, action="swept").inc()
            except Exception as e:
                logger.warning(f"chunk sweep of {obj} failed: {e!r}")

    try:
        asyncio.run(_run())
    finally:
        storage.close()
    if out["freed"] or out["stale_refs"] or out["stale_intents"]:
        logger.info(f"chunkstore reconcile at {store_url}: {out}")
    return out
