"""URL → StoragePlugin dispatch.

Protocols: ``fs`` (the default when no ``://`` is present) and
``memory``. The JAX package's other backends (``gs``, ``s3``,
``snapserve``) are not ported yet and raise.
"""

from typing import Dict, Optional

from .io_types import RetryingStoragePlugin, StoragePlugin
from .storage_plugins.fs import FSStoragePlugin
from .storage_plugins.memory import MemoryStoragePlugin

# Shared in-memory "buckets" keyed by name so that memory://foo resolves
# to the same store across plugin instances within a process.
_MEMORY_STORES: Dict[str, Dict[str, bytes]] = {}

_NOT_YET_PORTED = ("gs", "s3", "snapserve")


def url_to_storage_plugin(url_path: str) -> StoragePlugin:
    """Resolve a URL to its backend, wrapped with the retry policy."""
    if "://" in url_path:
        protocol, path = url_path.split("://", 1)
        protocol = protocol or "fs"
    else:
        protocol, path = "fs", url_path
    if protocol == "fs":
        return RetryingStoragePlugin(FSStoragePlugin(root=path))
    if protocol == "memory":
        bucket, _, prefix = path.partition("/")
        store = _MEMORY_STORES.setdefault(bucket, {})
        return RetryingStoragePlugin(MemoryStoragePlugin(store=store, prefix=prefix))
    if protocol in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"The {protocol}:// storage backend is not yet ported to "
            f"torchsnapshot_tpu_torch; use a local path or memory://."
        )
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


def resolve_base_ref(ref: str, own_path: str) -> str:
    """Resolve a snapshot reference as the JAX package records them in
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
