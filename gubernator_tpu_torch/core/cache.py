"""Host-side LRU cache with lazy TTL expiry (the port's copy of
gubernator_tpu/core/cache.py).

The exact-semantics backend (and differential-test oracle substrate) for the
rate-limit algorithms. Functionally equivalent to the reference's LRU
(reference cache/lru.go): map + recency list, lazy expiry on Get
(valid iff expire_at >= now, lru.go:104-121), upsert moves to front, evict
oldest beyond capacity, hit/miss stats.

The device slot store (core/store.py) is the scale backend; this one is
exact and is what serving uses when `backend="exact"`.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Hashable, Optional, Tuple

from gubernator_tpu_torch.api.types import millisecond_now

DEFAULT_MAX_SIZE = 50_000  # reference cache/lru.go:50


@dataclass
class CacheStats:
    size: int = 0
    hit: int = 0
    miss: int = 0


class _Record:
    __slots__ = ("value", "expire_at")

    def __init__(self, value: Any, expire_at: int):
        self.value = value
        self.expire_at = expire_at


class LRUCache:
    """LRU with per-entry TTL. Not thread-safe; callers serialize access the
    way the reference requires external Lock/Unlock (cache/types.go:33-34) —
    in this codebase all access is funneled through one asyncio event loop or
    the engine thread, so no lock object is exposed."""

    def __init__(self, max_size: int = DEFAULT_MAX_SIZE):
        if max_size <= 0:
            max_size = DEFAULT_MAX_SIZE
        self.max_size = max_size
        self._data: "OrderedDict[Hashable, _Record]" = OrderedDict()
        self._hit = 0
        self._miss = 0

    def __len__(self) -> int:
        return len(self._data)

    def add(self, key: Hashable, value: Any, expire_at: int) -> bool:
        """Upsert; moves entry to most-recent; evicts oldest beyond capacity."""
        rec = self._data.get(key)
        if rec is not None:
            rec.value = value
            rec.expire_at = expire_at
            self._data.move_to_end(key)
            return True
        self._data[key] = _Record(value, expire_at)
        while len(self._data) > self.max_size:
            self._data.popitem(last=False)
        return False

    def get(
        self, key: Hashable, now: Optional[int] = None
    ) -> Tuple[Optional[Any], bool]:
        rec = self._data.get(key)
        if rec is None:
            self._miss += 1
            return None, False
        if now is None:
            now = millisecond_now()
        if rec.expire_at < now:
            del self._data[key]
            self._miss += 1
            return None, False
        self._hit += 1
        self._data.move_to_end(key)
        return rec.value, True

    def peek(
        self, key: Hashable, now: Optional[int] = None
    ) -> Tuple[Optional[Any], bool]:
        """Non-mutating read: no recency move, no hit/miss accounting,
        no expired-entry deletion — get()'s observable state is
        untouched. This is the exact backend's snapshot surface for
        bucket replication (serve/replication.py): the flush loop must
        be able to read owned windows without perturbing what the
        serving path would do next (replication ON == OFF, provably)."""
        rec = self._data.get(key)
        if rec is None:
            return None, False
        if now is None:
            now = millisecond_now()
        if rec.expire_at < now:
            return None, False
        return rec.value, True

    def snapshot(self, key: Hashable):
        """(deep-copied value, expire_at) of the RAW record — expired
        or not — or None when absent. No recency move, no accounting,
        no deletion. With add()/remove(), lets a caller run an
        advisory decision pass and restore pristine state afterwards:
        the r15 chain peek uses this so a leaky level's peek-persisted
        leak credit (the reference's quirk) is not applied twice by
        the peek-then-debit two-phase (serve/backends.py
        ExactBackend.decide_chain)."""
        import copy

        rec = self._data.get(key)
        if rec is None:
            return None
        return copy.deepcopy(rec.value), rec.expire_at

    def remove(self, key: Hashable) -> None:
        self._data.pop(key, None)

    def update_expiration(self, key: Hashable, expire_at: int) -> bool:
        rec = self._data.get(key)
        if rec is None:
            return False
        rec.expire_at = expire_at
        return True

    def stats(self) -> CacheStats:
        return CacheStats(size=len(self._data), hit=self._hit, miss=self._miss)
