"""Text prefix cache — paper Algorithm 2, plus a block-aligned production mode
(a copy of the reference package's ``core/prefix_cache.py``).

The paper hashes every prefix of the prompt (SHA-256) and walks from the
longest down (O(n) hashes per lookup, O(n^2) bytes hashed).  We implement
that *faithful* variant (``block_size=1``) and a block-aligned hash-chain
variant (``block_size=16``, default):  ``h_i = H(h_{i-1} || block_i)`` — one
chain computation per lookup/insert, cache granularity of one block.  The
chain construction makes equal prefixes collide by construction regardless
of what follows (RadixAttention-style), and is our beyond-paper optimization
for long prompts.

Values are opaque to this module (the engine stores a (cache-pytree, length)
pair); eviction is byte-budget LRU.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lru import LRUCache

#: digest-scheme version, baked into the chain seed: token blocks are packed
#: as fixed-width little-endian int32 (constant-time per block) instead of
#: the v1 ASCII join, so v1 keys can never alias v2 entries
_SCHEME = b"prefix.v2:"


def _h(prev: bytes, chunk: Sequence[int]) -> bytes:
    m = hashlib.sha256(prev)
    m.update(np.asarray(chunk, "<i4").tobytes())
    return m.digest()


@dataclass
class LookupStats:
    """One count each per :meth:`TextPrefixCache.lookup` (the LRU's
    ``hits``/``misses`` count one per block length probed)."""
    lookups: int = 0
    lookup_hits: int = 0
    hit_tokens: int = 0      # matched tokens the hits returned


class TextPrefixCache:
    def __init__(self, block_size: int = 16,
                 max_bytes: int = 512 * 1024 * 1024,
                 on_evict: Optional[Callable[[str, Any], None]] = None):
        assert block_size >= 1
        self.block_size = block_size
        self._lru = LRUCache(max_bytes=max_bytes, on_evict=on_evict)
        self.lookup_stats = LookupStats()

    @property
    def stats(self):
        """The LRU's counters: ``hits`` and ``misses`` count probes, one
        per block length a lookup tries (see :attr:`lookup_stats`)."""
        return self._lru.stats

    def __len__(self) -> int:
        return len(self._lru)

    # ------------------------------------------------------------------ #
    def _chain(self, tokens: Sequence[int], salt: bytes) -> List[bytes]:
        """Hash-chain digests for every block-aligned prefix (ascending)."""
        bs = self.block_size
        out: List[bytes] = []
        prev = hashlib.sha256(_SCHEME + salt).digest()
        for i in range(0, len(tokens) - len(tokens) % bs, bs):
            prev = _h(prev, tokens[i:i + bs])
            out.append(prev)
        return out

    # ------------------------------------------------------------------ #
    def lookup(self, tokens: Sequence[int], *, salt: bytes = b"",
               max_len: Optional[int] = None) -> Tuple[Optional[Any], int]:
        """Longest cached block-aligned prefix of ``tokens``.

        ``max_len`` caps the usable match (the engine passes len(prompt)-1 so
        a full hit still leaves one token to produce first-step logits).
        Returns (value, matched_token_count) or (None, 0).
        """
        limit = len(tokens) if max_len is None else min(max_len, len(tokens))
        chain = self._chain(tokens[:limit], salt)
        st = self.lookup_stats
        st.lookups += 1
        for nblocks in range(len(chain), 0, -1):            # longest first
            val = self._lru.get(chain[nblocks - 1].hex())
            if val is not None:
                st.lookup_hits += 1
                st.hit_tokens += nblocks * self.block_size
                return val, nblocks * self.block_size
        return None, 0

    def insert(self, tokens: Sequence[int], value: Any, nbytes: int, *,
               salt: bytes = b"") -> int:
        """Cache ``value`` under the longest block-aligned prefix of
        ``tokens``.  Returns the cached prefix length (0 if too short)."""
        chain = self._chain(tokens, salt)
        if not chain:
            return 0
        self._lru.put(chain[-1].hex(), value, nbytes)
        return len(chain) * self.block_size

    # ------------------------------------------------------------------ #
    # exact-sequence entries (preemption snapshots)
    # ------------------------------------------------------------------ #
    def _exact_key(self, tokens: Sequence[int], salt: bytes) -> str:
        """Key for the *exact* token sequence (tail block included), in a
        separate namespace from the block-aligned chain so the two can never
        collide.  Used for preemption snapshots, where a resume must match
        the full prompt+generated history bit-for-bit or not at all."""
        chain = self._chain(tokens, salt)
        prev = chain[-1] if chain else hashlib.sha256(_SCHEME + salt).digest()
        tail = tokens[len(tokens) - len(tokens) % self.block_size:]
        return _h(b"exact:" + prev, tail).hex()

    def insert_exact(self, tokens: Sequence[int], value: Any, nbytes: int, *,
                     salt: bytes = b"") -> str:
        """Cache ``value`` under the exact token sequence.  The entry lives
        in the same byte-budget LRU as prefix entries, so an eviction
        snapshot competes with (and can be displaced by) ordinary prefix
        reuse — callers must treat a later miss as "re-prefill"."""
        key = self._exact_key(tokens, salt)
        self._lru.put(key, value, nbytes)
        return key

    def take_exact(self, tokens: Sequence[int], *, salt: bytes = b""
                   ) -> Optional[Any]:
        """Pop the exact-sequence entry for ``tokens`` (None if it was
        LRU-evicted).  Popping — not peeking — because a resumed request
        immediately diverges from the stored history, making the entry
        useless to anyone else."""
        key = self._exact_key(tokens, salt)
        value = self._lru.get(key)
        if value is not None:
            self._lru.discard(key)
        return value

    # ------------------------------------------------------------------ #
    # rolling partial publication (chunked prefill)
    # ------------------------------------------------------------------ #
    def key_for(self, tokens: Sequence[int], *, salt: bytes = b""
                ) -> Optional[str]:
        """The LRU key :meth:`insert` would store ``tokens`` under (None if
        shorter than one block).  The chunked-prefill engine uses this to
        *replace* a job's previous chunk-boundary entry instead of letting
        every boundary pile a full-size cache into the byte budget."""
        chain = self._chain(tokens, salt)
        return chain[-1].hex() if chain else None

    def discard(self, key: str) -> None:
        """Drop a previously inserted entry (superseded partial prefix)."""
        self._lru.discard(key)

    def evict_lru(self) -> bool:
        """Force-evict the least-recently-used entry (firing ``on_evict``).
        The paged KV pool calls this under page pressure: cache entries pin
        device pages, so freeing the oldest entry releases real arena
        capacity even when the host byte budget is nowhere near full."""
        return self._lru.evict_lru()

    def clear(self) -> None:
        """Drop every entry *without* firing ``on_evict`` — used by the
        catastrophic decode-block recovery path, where the page arena the
        entries lease from is itself being rebuilt (releasing leases into a
        dead allocator would be wrong in both directions)."""
        self._lru.clear()
