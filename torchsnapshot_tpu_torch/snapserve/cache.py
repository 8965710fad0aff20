"""Byte-capped, fingerprint-verified LRU content cache for the read plane.

Entries are immutable payload bytes keyed by ``backend-url + object path
+ manifest checksum`` (the server composes the key; a re-take that
rewrites an object under the same path changes its manifest checksum and
therefore its cache key, so stale content ages out instead of being
served). Every entry stores a content fingerprint computed at insert
time and re-verified on every hit: a corrupt entry (bit-rot, a bug
scribbling over the buffer) is dropped and counted, and the caller
re-fetches from the backend — the cache can serve stale nothing and
corrupt nothing.

The byte cap is a hard invariant, enforced under the lock at insert
time: concurrent fills evict before inserting, an object larger than
the cap is never admitted, and ``bytes_used <= cap_bytes`` holds at
every instant (tests/test_torch_snapserve.py hammers this from 16 threads).
"""

import threading
import weakref
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from .. import telemetry
from ..telemetry import memwatch
from ..telemetry import metrics as _metric_names


def content_fingerprint(data: bytes) -> str:
    """Cheap content tag for cache-hit verification (crc32 — the same
    family the manifest's storage checksums use; this tag never leaves
    the process and guards RAM, not storage)."""
    return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


class ByteLRU:
    """Thread-safe byte-capped LRU of immutable payloads."""

    def __init__(self, cap_bytes: int) -> None:
        self.cap_bytes = max(0, int(cap_bytes))
        self._entries: "OrderedDict[str, Tuple[bytes, str]]" = OrderedDict()
        self._bytes_used = 0
        self._high_water_bytes = 0
        self._lock = threading.Lock()
        self._stats: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "corrupt": 0,
            "evictions": 0,
            "inserts": 0,
            "oversize_skips": 0,
        }
        # snapmem: cache bytes are evictable by definition (pinned=0)
        # and retention is the point — no residual tracking. Several
        # ByteLRUs in one process (multi-server tests) aggregate under
        # the one domain name.
        self._mem_domain = memwatch.register(
            "snapserve.cache", cap_bytes=self.cap_bytes
        )
        weakref.finalize(self, self._mem_domain.close)

    def get(self, key: str) -> Optional[bytes]:
        """The cached payload, fingerprint-verified, or None. A failed
        verification evicts the entry and reports a miss (counted as
        ``corrupt``) so the caller re-fetches authoritative bytes."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._stats["misses"] += 1
                self._mem_domain.counter("misses")
                return None
            data, tag = entry
            if content_fingerprint(data) != tag:
                del self._entries[key]
                self._bytes_used -= len(data)
                self._stats["corrupt"] += 1
                self._stats["misses"] += 1
                self._mem_domain.counter("misses")
                self._publish_locked()
                return None
            self._entries.move_to_end(key)
            self._stats["hits"] += 1
            self._mem_domain.counter("hits")
            return data

    def put(self, key: str, data: bytes) -> bool:
        """Admit ``data`` under ``key``; returns False when the object
        cannot fit the cap at all (never admitted, never evicts)."""
        size = len(data)
        with self._lock:
            if size > self.cap_bytes:
                self._stats["oversize_skips"] += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes_used -= len(old[0])
            while self._bytes_used + size > self.cap_bytes and self._entries:
                _, (evicted, _tag) = self._entries.popitem(last=False)
                self._bytes_used -= len(evicted)
                self._stats["evictions"] += 1
                self._mem_domain.counter("evictions")
            self._entries[key] = (bytes(data), content_fingerprint(data))
            self._bytes_used += size
            self._high_water_bytes = max(
                self._high_water_bytes, self._bytes_used
            )
            self._stats["inserts"] += 1
            self._mem_domain.counter("inserts")
            self._publish_locked()
            return True

    def corrupt_for_test(self, key: str) -> bool:
        """Flip a byte of an entry IN PLACE (tests of the verify-on-hit
        contract only; payloads are stored as immutable ``bytes``, so
        the corruption is simulated by swapping the stored tuple)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or not entry[0]:
                return False
            data, tag = entry
            mangled = bytes([data[0] ^ 0xFF]) + data[1:]
            self._entries[key] = (mangled, tag)
            return True

    def _publish_locked(self) -> None:
        """Mirror occupancy into the gauges and the snapmem domain
        after every byte-moving transition (lock held; the high-water
        mutation lives at the byte-raising site in ``put``)."""
        telemetry.gauge(_metric_names.SNAPSERVE_CACHE_BYTES).set(
            float(self._bytes_used)
        )
        telemetry.gauge(_metric_names.SNAPSERVE_CACHE_HWM).set(
            float(self._high_water_bytes)
        )
        self._mem_domain.set_used(self._bytes_used, pinned_bytes=0)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes_used

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
            out["bytes_used"] = self._bytes_used
            out["entries"] = len(self._entries)
            out["cap_bytes"] = self.cap_bytes
            out["high_water_bytes"] = self._high_water_bytes
            return out
