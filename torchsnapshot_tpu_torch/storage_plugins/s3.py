"""S3 storage plugin.

Takes an injected client (a pre-built or fake boto3-style client, driven
from a thread pool); otherwise it imports ``aiobotocore`` (async), then
``boto3`` (in threads), inside the constructor, and raises an actionable
error when neither is installed. Keys are ``<root>/<path>`` in the
bucket; a ranged read sends an HTTP ``Range: bytes=<start>-<end - 1>``
(HTTP range ends are inclusive; the port's ``byte_range`` is half-open).
"""

import asyncio
import datetime
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

from .. import telemetry
from ..io_types import IOReq, StoragePlugin, is_not_found_error

_IO_THREADS = 8


class S3StoragePlugin(StoragePlugin):
    def __init__(self, root: str, client: Optional[Any] = None) -> None:
        components = root.split("/", 1)
        if len(components) != 2:
            raise ValueError(f'S3 root must be a "bucket/path" pair, got "{root}".')
        self.bucket, self.root = components
        if client is not None:
            self._client = client
            self._executor = ThreadPoolExecutor(max_workers=_IO_THREADS)
            self._mode = "sync"
            return
        try:
            from aiobotocore.session import get_session  # type: ignore

            self._session = get_session()
            self._mode = "aio"
        except ImportError:
            try:
                import boto3  # type: ignore
            except ImportError as e:
                raise RuntimeError("S3 support requires aiobotocore or boto3.") from e
            self._client = boto3.client("s3")
            self._executor = ThreadPoolExecutor(max_workers=_IO_THREADS)
            self._mode = "sync"

    def _key(self, path: str) -> str:
        return f"{self.root}/{path}"

    async def _call(self, method: str, **kwargs: Any) -> Any:
        """One client call: on a fresh aiobotocore client, or in the pool."""
        if self._mode == "aio":
            async with self._session.create_client("s3") as client:
                return await getattr(client, method)(**kwargs)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor, lambda: getattr(self._client, method)(**kwargs)
        )

    async def write(self, io_req: IOReq) -> None:
        if io_req.data is not None:
            body = bytes(io_req.data)
        else:
            body = io_req.buf.getvalue()
        t0 = time.monotonic()
        await self._call("put_object", Bucket=self.bucket, Key=self._key(io_req.path), Body=body)
        telemetry.record_storage_op("s3", "write", time.monotonic() - t0, len(body))

    async def read(self, io_req: IOReq) -> None:
        kwargs = {"Bucket": self.bucket, "Key": self._key(io_req.path)}
        if io_req.byte_range is not None:
            start, end = io_req.byte_range
            kwargs["Range"] = f"bytes={start}-{end - 1}"
        t0 = time.monotonic()
        if self._mode == "aio":
            async with self._session.create_client("s3") as client:
                response = await client.get_object(**kwargs)
                async with response["Body"] as stream:
                    io_req.data = await stream.read()
        else:
            loop = asyncio.get_running_loop()
            io_req.data = await loop.run_in_executor(
                self._executor, lambda: self._client.get_object(**kwargs)["Body"].read()
            )
        telemetry.record_storage_op(
            "s3", "read", time.monotonic() - t0,
            len(io_req.data) if io_req.data is not None else 0,
        )

    async def delete(self, path: str) -> None:
        t0 = time.monotonic()
        await self._call("delete_object", Bucket=self.bucket, Key=self._key(path))
        telemetry.record_storage_op("s3", "delete", time.monotonic() - t0)

    async def list_prefix(self, prefix: str) -> Optional[List[str]]:
        full_prefix = f"{self.root}/{prefix}" if prefix else f"{self.root}/"
        keys: List[str] = []
        if self._mode == "aio":
            async with self._session.create_client("s3") as client:
                paginator = client.get_paginator("list_objects_v2")
                async for page in paginator.paginate(Bucket=self.bucket, Prefix=full_prefix):
                    keys.extend(o["Key"] for o in page.get("Contents", []))
        else:

            def _list() -> List[str]:
                out: List[str] = []
                paginator = self._client.get_paginator("list_objects_v2")
                for page in paginator.paginate(Bucket=self.bucket, Prefix=full_prefix):
                    out.extend(o["Key"] for o in page.get("Contents", []))
                return out

            loop = asyncio.get_running_loop()
            keys = await loop.run_in_executor(self._executor, _list)
        return [k[len(self.root) + 1:] for k in keys]

    async def _head(self, path: str) -> Optional[dict]:
        """The object's HEAD, or None when it is missing. Any other failure
        propagates: a sweep's age guard then spares the object."""
        try:
            return await self._call("head_object", Bucket=self.bucket, Key=self._key(path))
        except Exception as e:
            if is_not_found_error(e):
                return None
            raise

    async def object_age_s(self, path: str) -> Optional[float]:
        head = await self._head(path)
        modified = None if head is None else head.get("LastModified")
        if modified is None:
            return None
        now = datetime.datetime.now(datetime.timezone.utc)
        return max(0.0, (now - modified).total_seconds())

    async def object_size_bytes(self, path: str) -> Optional[int]:
        head = await self._head(path)
        size = None if head is None else head.get("ContentLength")
        return None if size is None else int(size)

    def close(self) -> None:
        if self._mode == "sync":
            self._executor.shutdown(wait=True)
