"""URL → StoragePlugin dispatch, and the routing of references.

Protocols: ``fs`` (the default when no ``://`` is present), ``memory``,
``gs`` and ``s3`` (their SDKs imported only when such a URL is opened);
any other resolves through the ``storage_plugins`` entry-point group, so
third-party backends register themselves. ``snapserve`` is the read
plane's client (``snapserve://host:port/<backend-url>``, or
``snapserve://h1:p1,h2:p2/<backend-url>`` for a fleet).
``set_plugin_wrap_hook`` wraps every resolved backend under the retry
layer: fault injection's seam.

:class:`RefRouterPlugin` is the storage side of incremental and
content-chunked snapshots: a manifest entry whose payload lives in a base
snapshot (or in the run's chunk store) reads through an
``@base<N>/<location>`` path, which the router forwards to the root that
``SnapshotMetadata.base_paths[N]`` names. Roots are recorded ``rel:`` for
a sibling and ``abs:`` otherwise, so a moved snapshot family still
resolves.
"""

import logging
from importlib import metadata as importlib_metadata
from typing import Callable, Dict, List, Optional, Tuple

from .io_types import IOReq, RetryingStoragePlugin, StoragePlugin
from .storage_plugins.fs import FSStoragePlugin
from .storage_plugins.memory import MemoryStoragePlugin

logger = logging.getLogger(__name__)

# Shared in-memory "buckets" keyed by name so that memory://foo resolves
# to the same store across plugin instances within a process.
_MEMORY_STORES: Dict[str, Dict[str, bytes]] = {}

# Fault-injection seam (``faultline``): when set, every resolved backend
# is passed through this wrapper BEFORE the retry layer, so injected
# transient failures exercise the real retry policy while an injected
# crash (a BaseException) goes straight through it, as a real backend
# failure or process death would. Process-global on purpose: take,
# finalize and prune each resolve their own plugin, and one controller
# must observe them all as one op stream.
_PLUGIN_WRAP_HOOK: Optional[Callable[[StoragePlugin, str], StoragePlugin]] = None


def set_plugin_wrap_hook(hook):
    """Install (or, with None, clear) the plugin wrapper applied to every
    backend ``url_to_storage_plugin`` resolves; returns the previous hook
    so callers can restore it."""
    global _PLUGIN_WRAP_HOOK
    prev = _PLUGIN_WRAP_HOOK
    _PLUGIN_WRAP_HOOK = hook
    return prev


def url_to_storage_plugin(url_path: str) -> StoragePlugin:
    """Resolve a URL to its backend, wrapped with the retry policy (and,
    under it, the wrap hook when one is set)."""
    plugin = _resolve_plugin(url_path)
    if _PLUGIN_WRAP_HOOK is not None:
        plugin = _PLUGIN_WRAP_HOOK(plugin, url_path)
    return RetryingStoragePlugin(plugin)


def _resolve_plugin(url_path: str) -> StoragePlugin:
    if "://" in url_path:
        protocol, path = url_path.split("://", 1)
        protocol = protocol or "fs"
    else:
        protocol, path = "fs", url_path
    if protocol == "fs":
        return FSStoragePlugin(root=path)
    if protocol == "memory":
        bucket, _, prefix = path.partition("/")
        store = _MEMORY_STORES.setdefault(bucket, {})
        return MemoryStoragePlugin(store=store, prefix=prefix)
    if protocol == "gs":
        from .storage_plugins.gcs import GCSStoragePlugin

        return GCSStoragePlugin(root=path)
    if protocol == "s3":
        from .storage_plugins.s3 import S3StoragePlugin

        return S3StoragePlugin(root=path)
    if protocol == "snapserve":
        # The read plane (snapserve/): reads go through the caching read
        # service at host:port, everything else straight to the embedded
        # backend URL; an unreachable server degrades to direct backend
        # reads (counted, never an error).
        from .snapserve.client import SnapServePlugin

        return SnapServePlugin(path)
    # Third-party plugins register under the ``storage_plugins``
    # entry-point group, as for the JAX package.
    try:
        eps = importlib_metadata.entry_points()
        if hasattr(eps, "select"):
            group = list(eps.select(group="storage_plugins"))
        else:  # pragma: no cover
            group = list(eps.get("storage_plugins", []))
    except Exception:
        # Broken metadata of an unrelated package must not hide the
        # "unsupported protocol" error below, but it must show.
        logger.warning(
            f"Enumerating storage_plugins entry points for protocol "
            f"{protocol!r} failed",
            exc_info=True,
        )
        group = []
    for ep in group:
        if ep.name == protocol:
            # The plugin is installed: its load or constructor error is
            # the one to report.
            return ep.load()(path)
    raise RuntimeError(f"Unsupported protocol: {protocol}")


def _parent_url(url: str) -> Optional[str]:
    """The parent "directory" of a snapshot URL, or None when it has none
    (``memory://bucket``)."""
    trimmed = url.rstrip("/")
    if "://" in trimmed:
        scheme, _, rest = trimmed.partition("://")
        if "/" not in rest:
            return None
        return f"{scheme}://{rest.rpartition('/')[0]}"
    if "/" not in trimmed:
        return None
    return trimmed.rpartition("/")[0]


_REF_MARKER = "@base"


def make_ref_location(base_idx: int, location: str) -> str:
    return f"{_REF_MARKER}{base_idx}/{location}"


def parse_ref_location(path: str) -> Optional[Tuple[int, str]]:
    """``"@base<N>/<rest>"`` → ``(N, rest)``; None for ordinary paths.
    ``N`` must be plain ASCII digits, as :func:`make_ref_location` writes
    it: a sign or a Unicode digit would index the wrong root, or raise
    outside the corrupt-metadata guard."""
    if not path.startswith(_REF_MARKER):
        return None
    head, sep, rest = path.partition("/")
    digits = head[len(_REF_MARKER):]
    if not sep or not (digits.isascii() and digits.isdigit()):
        return None
    return int(digits), rest


def is_ref_location(path: str) -> bool:
    return parse_ref_location(path) is not None


def encode_base_ref(base_path: str, own_path: str) -> str:
    """A reference to ``base_path`` as recorded by ``own_path``: relative
    (``"rel:<name>"``) between siblings, so moving or renaming the whole
    family keeps it valid, else absolute (``"abs:<url>"``)."""
    bp, op = base_path.rstrip("/"), own_path.rstrip("/")
    b_parent, o_parent = _parent_url(bp), _parent_url(op)
    if b_parent is not None and b_parent == o_parent:
        return "rel:" + bp.rsplit("/", 1)[1]
    return "abs:" + bp


def resolve_base_ref(ref: str, own_path: str) -> str:
    """Resolve a snapshot reference as both packages record them in
    incremental back-links and ``base_paths``: ``rel:<name>`` names a
    sibling of ``own_path``, ``abs:<url>`` any location."""
    if ref.startswith("rel:"):
        parent = _parent_url(own_path.rstrip("/"))
        if parent is None:
            raise ValueError(
                f"Cannot resolve relative reference {ref!r}: snapshot path "
                f"{own_path!r} has no parent directory"
            )
        return f"{parent}/{ref[4:]}"
    if ref.startswith("abs:"):
        return ref[4:]
    raise ValueError(f"Malformed snapshot reference: {ref!r}")


class RefRouterPlugin(StoragePlugin):
    """Routes ``@base<N>/…`` paths to the roots attached with
    :meth:`attach_bases`; other paths go to the snapshot's own plugin. Base plugins open on first use
    and close with the router. Writes and deletes of ``@base`` paths are
    refused: a snapshot never changes objects another snapshot owns."""

    def __init__(self, inner: StoragePlugin) -> None:
        self._inner = inner
        self._base_urls: List[str] = []
        self._base_plugins: Dict[int, StoragePlugin] = {}
        self.max_write_concurrency = inner.max_write_concurrency
        self.max_read_concurrency = inner.max_read_concurrency

    def attach_bases(self, base_urls: List[str]) -> None:
        self._base_urls = list(base_urls)

    def _route(self, path: str) -> Tuple[StoragePlugin, str]:
        parsed = parse_ref_location(path)
        if parsed is None:
            return self._inner, path
        idx, rest = parsed
        if idx >= len(self._base_urls):
            raise RuntimeError(
                f"Manifest references base snapshot #{idx} but metadata "
                f"records only {len(self._base_urls)} base path(s): "
                f"corrupt or truncated metadata"
            )
        plugin = self._base_plugins.get(idx)
        if plugin is None:
            plugin = self._base_plugins[idx] = url_to_storage_plugin(self._base_urls[idx])
        return plugin, rest

    async def write(self, io_req: IOReq) -> None:
        if is_ref_location(io_req.path):
            raise RuntimeError(f"Refusing to write into a base snapshot: {io_req.path}")
        await self._inner.write(io_req)

    async def read(self, io_req: IOReq) -> None:
        plugin, path = self._route(io_req.path)
        if plugin is self._inner:
            await plugin.read(io_req)
            return
        routed = IOReq(path=path, buf=io_req.buf, byte_range=io_req.byte_range)
        await plugin.read(routed)
        io_req.data = routed.data

    async def delete(self, path: str) -> None:
        if is_ref_location(path):
            raise RuntimeError(
                f"Refusing to delete an object owned by a base snapshot: {path}"
            )
        await self._inner.delete(path)

    async def list_prefix(self, prefix: str) -> Optional[List[str]]:
        # Enumeration stays within the snapshot's own prefix.
        return await self._inner.list_prefix(prefix)

    async def object_age_s(self, path: str) -> Optional[float]:
        plugin, p = self._route(path)
        return await plugin.object_age_s(p)

    async def object_size_bytes(self, path: str) -> Optional[int]:
        plugin, p = self._route(path)
        return await plugin.object_size_bytes(p)

    def ensure_durable(self) -> None:
        self._inner.ensure_durable()

    def close(self) -> None:
        for plugin in self._base_plugins.values():
            try:
                plugin.close()
            except Exception:  # best-effort teardown
                logger.warning("base plugin close failed", exc_info=True)
        self._base_plugins.clear()
        self._inner.close()
