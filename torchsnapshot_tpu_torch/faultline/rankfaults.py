"""Rank-fault injection for coordinator collectives.

Models the multi-process failure the storage-side harness cannot: a rank
that dies (or wedges) BEFORE publishing its collective key. The healthy
ranks must fail fast with the shared-deadline ``TimeoutError`` that NAMES
the stalled rank(s) — never hang for world × timeout, never blame a
healthy peer.

:class:`MuteRankStore` wraps any :class:`~torchsnapshot_tpu_torch.coord.Store`
and silently drops ``set()`` calls for the muted rank's publish keys
(barrier arrivals, all-gather values and their chunk parts, broadcast
acks) — the rank executes the collective but its writes never become
visible, exactly what process death after the local call looks like to
everyone else.
"""

import fnmatch
from typing import List, Optional

from ..coord import Store


def mute_patterns_for_rank(rank: int) -> List[str]:
    """The key globs a rank publishes through (see StoreCoordinator).
    The keys are the coordinator's own: a ``TorchStore`` adds its
    ``PrefixStore`` namespace below this wrapper, so the globs match over
    a c10d store too."""
    return [
        f"b/*/{rank}",           # barrier arrival
        f"ag/*/{rank}",          # all-gather value (chunk head)
        f"ag/*/{rank}/part*",    # all-gather chunk parts
        f"bcack/*/{rank}",       # broadcast ack
    ]


class MuteRankStore(Store):
    """Drop publishes matching the muted rank's key patterns.

    ``mute_after`` optionally lets the first N matching publishes
    through — the rank "dies" partway into a chunked publish, leaving a
    torn value (head without parts, or some parts missing) that readers
    must treat as "never finished publishing", not garbage.
    """

    def __init__(
        self,
        inner: Store,
        rank: int,
        mute_after: int = 0,
        patterns: Optional[List[str]] = None,
    ) -> None:
        self._inner = inner
        self._patterns = (
            patterns if patterns is not None else mute_patterns_for_rank(rank)
        )
        self._let_through = mute_after
        self.dropped: List[str] = []

    def _muted(self, key: str) -> bool:
        if not any(fnmatch.fnmatchcase(key, p) for p in self._patterns):
            return False
        if self._let_through > 0:
            self._let_through -= 1
            return False
        return True

    def set(self, key: str, value: bytes) -> None:
        if self._muted(key):
            self.dropped.append(key)
            return
        self._inner.set(key, value)

    def get(self, key: str, timeout_s: float = 300.0) -> bytes:
        return self._inner.get(key, timeout_s)

    def delete(self, key: str) -> None:
        self._inner.delete(key)

    def try_get(self, key: str):
        return self._inner.try_get(key)
