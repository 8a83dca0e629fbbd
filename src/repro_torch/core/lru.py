"""Byte-budget LRU store (paper §3.3 Memory Management, default 512 MB); a
copy of the reference package's ``core/lru.py``.

Keys are content hashes; values are arbitrary objects with a caller-supplied
byte size.  Eviction is strict LRU on *access* order.  Thread-unsafe by
design (the engine is single-threaded per step, like the paper's)."""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    bytes_evicted: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class LRUCache:
    def __init__(self, max_bytes: int = 512 * 1024 * 1024,
                 on_evict: Optional[Callable[[str, Any], None]] = None):
        self.max_bytes = max_bytes
        self._store: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self._on_evict = on_evict
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: str) -> bool:
        return key in self._store

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key: str) -> Optional[Any]:
        if key not in self._store:
            self.stats.misses += 1
            return None
        self._store.move_to_end(key)
        self.stats.hits += 1
        return self._store[key][0]

    def peek(self, key: str) -> Optional[Any]:
        """Get without touching LRU order or stats."""
        entry = self._store.get(key)
        return entry[0] if entry else None

    def put(self, key: str, value: Any, nbytes: int) -> None:
        if key in self._store:
            old_value, old = self._store.pop(key)
            self._bytes -= old
            # a replaced value is as gone as an evicted one — fire the
            # callback so resources it pins (e.g. paged-KV leases) are
            # released; same-object re-puts skip (nothing was displaced)
            if self._on_evict and old_value is not value:
                self._on_evict(key, old_value)
        if nbytes > self.max_bytes:
            # would never fit: dropped on the floor — still "evicted" from
            # the resource-pinning point of view
            if self._on_evict:
                self._on_evict(key, value)
            return
        self._store[key] = (value, nbytes)
        self._bytes += nbytes
        self.stats.insertions += 1
        self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        while self._bytes > self.max_bytes and self._store:
            key, (value, nbytes) = self._store.popitem(last=False)
            self._bytes -= nbytes
            self.stats.evictions += 1
            self.stats.bytes_evicted += nbytes
            if self._on_evict:
                self._on_evict(key, value)

    def discard(self, key: str) -> None:
        """Drop an entry if present (no eviction callback, no stats)."""
        entry = self._store.pop(key, None)
        if entry is not None:
            self._bytes -= entry[1]

    def evict_lru(self) -> bool:
        """Force-evict the least-recently-used entry (with callback + stats),
        regardless of budget — used by the paged KV pool to reclaim device
        pages held by cache entries when the page arena, not the host byte
        budget, is the scarce resource.  Returns False on an empty cache."""
        if not self._store:
            return False
        key, (value, nbytes) = self._store.popitem(last=False)
        self._bytes -= nbytes
        self.stats.evictions += 1
        self.stats.bytes_evicted += nbytes
        if self._on_evict:
            self._on_evict(key, value)
        return True

    def evict(self, key: str) -> bool:
        """Force-evict one specific entry (with callback + stats) — the
        targeted sibling of :meth:`evict_lru`, used when only entries of a
        certain kind pin the scarce resource (e.g. cross-KV page leases)."""
        entry = self._store.pop(key, None)
        if entry is None:
            return False
        value, nbytes = entry
        self._bytes -= nbytes
        self.stats.evictions += 1
        self.stats.bytes_evicted += nbytes
        if self._on_evict:
            self._on_evict(key, value)
        return True

    def keys(self) -> Iterator[str]:
        return iter(self._store.keys())

    def clear(self) -> None:
        self._store.clear()
        self._bytes = 0
