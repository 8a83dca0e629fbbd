"""Content-based multimodal prefix cache — paper Algorithm 3 (a copy of the
reference package's ``core/content_cache.py``).

The key property (paper §3.3): identical media hit the same entry *regardless
of input format* — URL, base64, file path, raw array — because the SHA-256
is computed over **decoded pixel values** (canonicalised to uint8 bytes plus
shape/dtype header), not over the transport encoding.

Two entry kinds:
  * per-frame **embedding** entries (skip the vision/audio encoder), keyed by
    a single frame's content hash;
  * per-media-set **cross-KV** entries (skip the per-layer xk/xv projection
    of the context during prefill), keyed by the digest of the frame-hash
    list — videos with shared frames share embedding entries even when the
    set digest differs (paper §4.2 video caching).

Eviction: byte-budget LRU (default 512 MB, paper §3.3).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.lru import LRUCache


def content_hash(pixels: np.ndarray) -> str:
    """SHA-256 over decoded, canonicalised pixel values (format-independent).

    Canonicalisation maps every dtype onto uint8 through one clip/round
    path: floats are treated as [0, 1] intensities and scaled by 255; wider
    integers are clipped to [0, 255] (``np.rint``, not truncation — a naive
    ``.astype(np.uint8)`` wraps mod 256 and silently aliases distinct
    images, e.g. uint16 pixel value 256 colliding with 0).  The salt is
    version-bumped so hashes from the pre-fix scheme can never alias
    entries computed under this one.
    """
    arr = np.ascontiguousarray(pixels)
    if arr.dtype != np.uint8:
        wide = arr.astype(np.float64)
        scaled = (np.clip(wide, 0.0, 1.0) * 255.0 if arr.dtype.kind == "f"
                  else np.clip(wide, 0.0, 255.0))
        arr = np.rint(scaled).astype(np.uint8)
    m = hashlib.sha256(b"content-hash/2")
    m.update(str(arr.shape).encode())
    m.update(arr.tobytes())
    return m.hexdigest()


def media_set_digest(frame_hashes: Sequence[str]) -> str:
    m = hashlib.sha256(b"media-set")
    for h in frame_hashes:
        m.update(bytes.fromhex(h))
    return m.hexdigest()


@dataclass
class MediaStats:
    """Engine-side multimodal counters — they exist (and the singleflight
    dedup invariant holds) even with the content cache disabled, so the
    in-flight dedup proof never depends on caching being on."""
    encoder_invocations: int = 0    # unique encoder calls (the dedup proof)
    encode_waves: int = 0           # batched encode waves dispatched
    dedup_joins: int = 0            # requests that joined an in-flight encode
    embed_hits: int = 0             # per-frame embedding-cache hits
    embed_misses: int = 0
    xkv_hits: int = 0               # per-media-set cross-KV hits
    xkv_misses: int = 0
    xkv_lease_pages: int = 0        # device pages currently leased by xkv
    xkv_publish_skipped: int = 0    # publications dropped under page pressure


@dataclass
class EmbeddingEntry:
    embeddings: Any                 # [T_frame, De] precomputed frame embedding
    nbytes: int


@dataclass
class CrossKVEntry:
    xkv: Any                        # per-layer {'xk','xv'} pytree (batch=1)
    num_tokens: int
    nbytes: int
    # device-page accounting lease under --kv-layout paged: the entry's
    # bytes are charged against the shared KV page arena, so the admission
    # headroom probe and the page-pressure ladder see media residency too.
    # None/[] under the dense layout or after a lease detach (arena rebuild)
    pages: Optional[List[int]] = field(default=None)


class ContentCache:
    def __init__(self, max_bytes: int = 512 * 1024 * 1024, *,
                 cache_embeddings: bool = True, cache_kv: bool = True,
                 on_evict: Optional[Callable[[str, Any], None]] = None):
        self._lru = LRUCache(max_bytes=max_bytes, on_evict=on_evict)
        self.cache_embeddings = cache_embeddings
        self.cache_kv = cache_kv

    @property
    def stats(self):
        return self._lru.stats

    @property
    def nbytes(self) -> int:
        return self._lru.nbytes

    def __len__(self) -> int:
        return len(self._lru)

    # -- per-frame embeddings ------------------------------------------- #
    def get_embedding(self, frame_hash: str) -> Optional[EmbeddingEntry]:
        if not self.cache_embeddings:
            return None
        val = self._lru.get("emb:" + frame_hash)
        return val

    def put_embedding(self, frame_hash: str, entry: EmbeddingEntry) -> None:
        if self.cache_embeddings:
            self._lru.put("emb:" + frame_hash, entry, entry.nbytes)

    # -- per-media-set cross KV ----------------------------------------- #
    def get_cross_kv(self, set_digest: str) -> Optional[CrossKVEntry]:
        if not self.cache_kv:
            return None
        return self._lru.get("xkv:" + set_digest)

    def put_cross_kv(self, set_digest: str, entry: CrossKVEntry) -> None:
        if self.cache_kv:
            self._lru.put("xkv:" + set_digest, entry, entry.nbytes)

    # -- device-residency bookkeeping (paged KV arena) ------------------ #
    def evict_cross_kv_lru(self) -> bool:
        """Force-evict the least-recently-used cross-KV entry (on_evict
        fires, releasing its page lease) — a rung of the engine's page
        -pressure ladder.  Embedding entries are skipped: they hold no
        device pages, so evicting them frees nothing the ladder wants."""
        for key in self._lru.keys():
            if key.startswith("xkv:"):
                return self._lru.evict(key)
        return False

    def detach_page_leases(self) -> None:
        """Null every cross-KV entry's page lease *without* firing eviction
        callbacks — used after a catastrophic arena rebuild, when the old
        allocator (and every page id minted by it) is gone.  The xkv arrays
        themselves stay valid: they are their own device buffers, not views
        into the donated pool cache."""
        for key in list(self._lru.keys()):
            if key.startswith("xkv:"):
                entry = self._lru.peek(key)
                if entry is not None:
                    entry.pages = None
