"""Google Cloud Storage plugin.

Takes an injected client (a pre-built or fake ``storage.Client``);
otherwise it imports ``google.cloud.storage`` inside the constructor and
builds a client from ambient credentials. The sync client runs in a
thread pool. Keys are ``<root>/<path>`` in the bucket; a ranged read maps
the half-open ``byte_range`` to ``download_as_bytes(start, end - 1)``
(GCS ends are inclusive).

An object of at least ``TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES`` (64 MiB)
uploads as concurrent parts and one server-side compose (GCS composes at
most 32 components, so parts grow rather than exceed that). The parts
are named with a nonce and deleted afterwards, on failure too; the
composed object's size is checked against the payload, and any failure
raises out of the write, so the retry layer re-runs the whole object.
Parts a crashed process left behind are removed by
``Snapshot.delete(sweep=True)``.
"""

import asyncio
import datetime
import io
import logging
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

from .. import telemetry
from ..io_types import IOReq, StoragePlugin, io_payload, is_not_found_error
from ..utils.env import env_int

logger = logging.getLogger(__name__)

_IO_THREADS = 8
_PARALLEL_UPLOAD_ENV = "TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES"
_DEFAULT_PARALLEL_UPLOAD_BYTES = 64 * 1024 * 1024
_MAX_COMPOSE_COMPONENTS = 32


def _parallel_upload_threshold() -> int:
    return env_int(_PARALLEL_UPLOAD_ENV, _DEFAULT_PARALLEL_UPLOAD_BYTES)


class GCSStoragePlugin(StoragePlugin):
    def __init__(self, root: str, client: Optional[Any] = None) -> None:
        components = root.split("/", 1)
        if len(components) != 2:
            raise ValueError(f'GCS root must be a "bucket/path" pair, got "{root}".')
        self.bucket_name, self.root = components
        if client is None:
            try:
                from google.cloud import storage  # type: ignore
            except ImportError as e:
                raise RuntimeError("GCS support requires the google-cloud-storage package.") from e
            client = storage.Client()
        self._client = client
        self._bucket = client.bucket(self.bucket_name)
        self._executor = ThreadPoolExecutor(max_workers=_IO_THREADS)

    def _blob(self, path: str) -> Any:
        return self._bucket.blob(f"{self.root}/{path}")

    def _upload_sync(self, key: str, payload: Any) -> None:
        self._bucket.blob(key).upload_from_file(io.BytesIO(payload))

    async def _parallel_composite_upload(self, path: str, payload: Any) -> None:
        view = memoryview(payload)
        n_parts = min(
            _MAX_COMPOSE_COMPONENTS, max(1, -(-len(view) // _parallel_upload_threshold()))
        )
        bounds = [len(view) * i // n_parts for i in range(n_parts + 1)]
        nonce = uuid.uuid4().hex[:12]
        part_keys = [f"{self.root}/{path}.part{i}.{nonce}" for i in range(n_parts)]
        loop = asyncio.get_running_loop()
        try:
            await asyncio.gather(
                *(
                    loop.run_in_executor(
                        self._executor, self._upload_sync, part_keys[i], view[bounds[i]:bounds[i + 1]]
                    )
                    for i in range(n_parts)
                )
            )

            def _compose_and_check() -> None:
                blob = self._blob(path)
                blob.compose([self._bucket.blob(k) for k in part_keys])
                # One metadata op: a part truncated or replaced by an
                # interfering upload shows as a size mismatch here, inside
                # the retry layer, not at restore.
                try:
                    blob.reload()
                    composed = blob.size
                except (AttributeError, NotImplementedError):
                    return  # a backend without metadata reload
                if composed is not None and composed != len(view):
                    raise RuntimeError(
                        f"GCS composite upload of {path}: composed object is "
                        f"{composed} bytes, expected {len(view)}"
                    )

            await loop.run_in_executor(self._executor, _compose_and_check)
        finally:

            def _delete_part(key: str) -> None:
                try:
                    self._bucket.blob(key).delete()
                except Exception:
                    # A leaked part costs storage, not correctness (a
                    # sweep removes it); logged so a systematic failure shows.
                    logger.warning(f"deleting upload part {key} failed", exc_info=True)

            await asyncio.gather(
                *(loop.run_in_executor(self._executor, _delete_part, k) for k in part_keys)
            )

    async def write(self, io_req: IOReq) -> None:
        payload = io_payload(io_req)
        t0 = time.monotonic()
        if len(payload) >= _parallel_upload_threshold():
            await self._parallel_composite_upload(io_req.path, payload)
        else:
            loop = asyncio.get_running_loop()
            key = f"{self.root}/{io_req.path}"
            await loop.run_in_executor(self._executor, self._upload_sync, key, payload)
        telemetry.record_storage_op("gcs", "write", time.monotonic() - t0, len(payload))

    def _read_sync(self, io_req: IOReq) -> None:
        blob = self._blob(io_req.path)
        if io_req.byte_range is None:
            io_req.data = blob.download_as_bytes()
        else:
            start, end = io_req.byte_range
            io_req.data = blob.download_as_bytes(start=start, end=end - 1)

    async def read(self, io_req: IOReq) -> None:
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        await loop.run_in_executor(self._executor, self._read_sync, io_req)
        telemetry.record_storage_op(
            "gcs", "read", time.monotonic() - t0,
            len(io_req.data) if io_req.data is not None else 0,
        )

    async def delete(self, path: str) -> None:
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        await loop.run_in_executor(self._executor, self._blob(path).delete)
        telemetry.record_storage_op("gcs", "delete", time.monotonic() - t0)

    def _list_sync(self, prefix: str) -> List[str]:
        full_prefix = f"{self.root}/{prefix}" if prefix else f"{self.root}/"
        blobs = self._client.list_blobs(self.bucket_name, prefix=full_prefix)
        return [b.name[len(self.root) + 1:] for b in blobs]

    async def list_prefix(self, prefix: str) -> Optional[List[str]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, self._list_sync, prefix)

    async def _reloaded(self, path: str) -> Optional[Any]:
        """The blob with its metadata loaded, or None when it is missing.
        Any other failure propagates: a sweep's age guard then spares the
        object."""
        blob = self._blob(path)
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(self._executor, blob.reload)
        except Exception as e:
            if is_not_found_error(e):
                return None
            raise
        return blob

    async def object_age_s(self, path: str) -> Optional[float]:
        blob = await self._reloaded(path)
        updated = None if blob is None else getattr(blob, "updated", None)
        if updated is None:
            return None
        if isinstance(updated, (int, float)):
            return max(0.0, time.time() - updated)
        now = datetime.datetime.now(datetime.timezone.utc)
        return max(0.0, (now - updated).total_seconds())

    async def object_size_bytes(self, path: str) -> Optional[int]:
        blob = await self._reloaded(path)
        size = None if blob is None else getattr(blob, "size", None)
        return None if size is None else int(size)

    def close(self) -> None:
        self._executor.shutdown(wait=True)
