"""Paged KV pool of the port: a global page arena + per-slot page tables +
copy-on-write sharing (the reference package's ``core/paged_kv.py``, less
what only preemption and speculative decoding call).

KV memory is one arena of ``num_pages`` fixed-size pages per attention
layer — ``k``/``v`` leaves are ``[N, page_size, Hkv, hd]`` (stacked block
layers ``[L, N, ...]``) — and each slot owns an ordered list of page ids,
mirrored into a page table ``[max_batch, pages_per_slot]`` (int32) on the
engine's device that the decode steps thread through attention
(:func:`repro_torch.kernels.ops.paged_attention`).  The cross-attention
leaves (``xk``/``xv``) stay dense per slot: O(1) per slot, paging them buys
nothing.

Sharing is copy-on-write at page granularity: a prefix-cache hit maps
already-materialised pages into the new owner's table with a refcount bump
— no bytes move — and a page is copied (split) only when a writer needs a
cell of a page someone else can still read.  **A page is writable iff its
refcount is 1**; the engine calls :meth:`PagedKVPool.ensure_decode_capacity`
before every decode block so the pages the block writes are exclusively
owned by then.

Unlike the reference (immutable arrays donated through ``jit``), the port
updates the arena in place: the COW split, the commit scatter and the
decode writes are indexed copies into ``self.cache``.  The host page table
is copied to the device table (a blocking copy, so the host may mutate its
buffer right after) whenever it changed, before the next decode block.

Page ids and their order equal the reference's: the same reserved prefix
(one trash cell ``(b // ps, b % ps)`` per slot for frozen-slot decode
writes, then the scratch page) and the same deterministic free list, so page
tables and :class:`PageStats` compare one to one across the two packages.

Int8 KV (``kv_dtype="int8"``): pages are stored quantised per (position,
kv-head) by :func:`repro_torch.kernels.quant_matmul.quantize_kv_int8`;
scales ride in ``k_scale``/``v_scale`` arena leaves ``[N, page_size, Hkv]``
(f32) and are applied inside the attention op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.kv_cache import tree_bytes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.quant_matmul import quantize_kv_int8
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import init_cache

ARENA_KEYS = ("k", "v", "k_scale", "v_scale")


class PagePoolExhausted(RuntimeError):
    """No free pages left in the arena.  The engine reacts with its pressure
    ladder: reclaim prefix-cache leases first."""


@dataclass
class PageStats:
    """Allocator counters.  ``full_copies`` counts admissions that fell back
    to materialising every page of an already-cached prefix — the COW
    acceptance gate asserts it stays 0 (sharing is by table mapping, never
    by byte copy)."""
    allocs: int = 0
    frees: int = 0
    shares: int = 0          # incref of an already-owned page (COW mapping)
    cow_splits: int = 0      # page copied because a writer hit refcount > 1
    full_copies: int = 0


class PageAllocator:
    """Host-side free-list + refcount allocator over ``num_pages`` page ids.

    Pure host bookkeeping (no device state).  Page ids ``[0, reserved)`` are
    never handed out: the engine uses them as trash cells for frozen-slot
    decode writes and as the scratch page, so a redirected write can never
    land on a real page.
    """

    def __init__(self, num_pages: int, reserved: int = 0):
        assert num_pages > reserved >= 0
        self.num_pages = num_pages
        self.reserved = reserved
        self._free: List[int] = list(range(reserved, num_pages))[::-1]
        self._ref: List[int] = [0] * num_pages
        self.stats = PageStats()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocatable(self) -> int:
        return self.num_pages - self.reserved

    def alloc(self) -> int:
        if not self._free:
            raise PagePoolExhausted(
                f"all {self.num_allocatable} KV pages in use")
        page = self._free.pop()
        assert self._ref[page] == 0
        self._ref[page] = 1
        self.stats.allocs += 1
        return page

    def incref(self, page: int) -> None:
        assert self._ref[page] > 0, f"incref of unowned page {page}"
        self._ref[page] += 1
        self.stats.shares += 1

    def decref(self, page: int) -> None:
        assert self._ref[page] > 0, f"double free of page {page}"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            self.stats.frees += 1

    def refcount(self, page: int) -> int:
        return self._ref[page]


def _arena_leaves(cache):
    """(leaf dict, stacked) for every layer of a cache tree: prefix layers
    ``[N, ...]``, stacked block layers ``[L, N, ...]``."""
    for sub in cache["prefix"]:
        yield sub, False
    for sub in (cache.get("block") or {}).values():
        yield sub, True


class PagedKVPool:
    """Decode pool with a paged arena (the :class:`SlotKVPool` surface plus
    paging), on ``device`` (``cuda`` unless the caller asks for another).

    Slot allocation (``allocate``/``free``/``num_free``) is unchanged; KV
    bytes live in the shared arena and a slot's footprint is the pages it
    actually holds.  ``num_pages=None`` sizes the arena for full capacity
    (``max_batch * pages_per_slot`` + reserved) — exhaustion then requires
    cache leases, which the engine's pressure ladder can always reclaim.
    """

    def __init__(self, cfg: ModelConfig, max_batch: int, cache_len: int, *,
                 ctx_len: int = 0, dtype=None, page_size: int = 16,
                 num_pages: Optional[int] = None, kv_dtype: str = "fp",
                 device: DeviceLike = None):
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype must be 'fp' or 'int8', got "
                             f"{kv_dtype!r}")
        page_size = min(page_size, cache_len)
        if cache_len % page_size:
            raise ValueError(f"cache_len={cache_len} must be a multiple of "
                             f"page_size={page_size}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.ctx_len = ctx_len
        self.page_size = page_size
        self.pages_per_slot = cache_len // page_size
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        # reserved arena prefix: one trash cell (page b//ps, offset b%ps)
        # per slot for frozen-slot decode writes, plus one scratch page (the
        # reference's masked-insert target; the port's commit writes fresh
        # pages only, but keeps the page so ids stay equal)
        self.reserved = -(-max_batch // page_size) + 1
        if num_pages is None:
            num_pages = self.full_capacity(max_batch, cache_len, page_size)
        if num_pages <= self.reserved:
            raise ValueError(f"kv_num_pages={num_pages} leaves no page past "
                             f"the {self.reserved} reserved ones")
        self.num_pages = num_pages
        self.allocator = PageAllocator(num_pages, reserved=self.reserved)

        self._free: List[int] = list(range(max_batch))[::-1]
        self._used: Set[int] = set()
        self._slot_pages: Dict[int, List[int]] = {}
        self._pt_host = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self._pt_dirty = False
        self._zeros = None
        self._dense_dtype = dtype_of(cfg.dtype) if dtype is None else dtype
        self.cache = self._init_arena()
        self._page_bytes = sum(
            leaf[:, 0].numel() * leaf.element_size() if stacked
            else leaf[0].numel() * leaf.element_size()
            for sub, stacked in _arena_leaves(self.cache)
            for name, leaf in sub.items() if name in ARENA_KEYS)
        self.stats = self.allocator.stats                  # alias

    @staticmethod
    def full_capacity(max_batch: int, cache_len: int, page_size: int) -> int:
        """Pages of an arena sized for every slot's full ring, reserved
        pages included (the ``num_pages=None`` default)."""
        page_size = min(page_size, cache_len)
        return (-(-max_batch // page_size) + 1
                + max_batch * (cache_len // page_size))

    def _init_arena(self):
        n, ps = self.num_pages, self.page_size
        int8 = self.kv_dtype == "int8"
        # the dense layout's shapes, without allocating it
        shapes = init_cache(self.cfg, self.max_batch, 1, ctx_len=self.ctx_len,
                            dtype=self._dense_dtype, device="meta")

        def to_arena(sub, stacked):
            out = {}
            for name, leaf in sub.items():
                if name not in ("k", "v"):      # cross KV: dense per slot
                    out[name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                            device=self.device)
                    continue
                lead = (leaf.shape[0],) if stacked else ()
                shape = lead + (n, ps) + tuple(leaf.shape[-2:])
                out[name] = torch.zeros(shape, device=self.device,
                                        dtype=torch.int8 if int8 else leaf.dtype)
                if int8:
                    out[name + "_scale"] = torch.ones(
                        shape[:-1], dtype=torch.float32, device=self.device)
            return out

        arena = {"prefix": [to_arena(sub, False) for sub in shapes["prefix"]]}
        arena["block"] = (
            {pos: to_arena(sub, True) for pos, sub in shapes["block"].items()}
            if shapes.get("block") is not None else None)
        arena["page_table"] = torch.zeros(self._pt_host.shape,
                                          dtype=torch.int32,
                                          device=self.device)
        return arena

    # ------------------------------------------------------------------ #
    # slot allocation (SlotKVPool surface)
    # ------------------------------------------------------------------ #
    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"double free of slot {slot}")
        self._used.remove(slot)
        self._free.append(slot)
        for page in self._slot_pages.pop(slot, []):
            self.allocator.decref(page)
        self._pt_host[slot] = 0
        self._pt_dirty = True

    # ------------------------------------------------------------------ #
    # page bookkeeping
    # ------------------------------------------------------------------ #
    def slot_pages(self, slot: int) -> List[int]:
        return self._slot_pages.get(slot, [])

    def incref_pages(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.allocator.incref(p)

    def release_pages(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.allocator.decref(p)

    @property
    def page_bytes(self) -> int:
        """Device bytes of ONE page summed over every arena leaf."""
        return self._page_bytes

    def pages_nbytes(self, npages: int) -> int:
        return npages * self._page_bytes

    def page_occupancy(self) -> Dict[str, int]:
        """Real arena occupancy: ``free`` pages are immediately allocatable;
        ``reclaimable`` are held only by cache leases (prefix entries),
        which the pressure ladder can evict; ``pinned`` back live slots."""
        free = self.allocator.num_free
        pinned = len({p for pages in self._slot_pages.values()
                      for p in pages})
        total = self.allocator.num_allocatable
        return {"total": total, "free": free, "pinned": pinned,
                "reclaimable": total - free - pinned}

    def sync_page_table(self) -> None:
        """Copy the host page table to the device table if it changed.  The
        copy is blocking, so the host buffer may change right after."""
        if self._pt_dirty:
            self.cache["page_table"].copy_(torch.from_numpy(self._pt_host))
            self._pt_dirty = False

    def _index(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.int64,
                               device=self.device)

    # ------------------------------------------------------------------ #
    # admission / publication
    # ------------------------------------------------------------------ #
    def insert_many(self, slots: Sequence[int], single_caches,
                    consumed: Optional[Sequence[int]] = None,
                    shared: Optional[Sequence[Sequence[int]]] = None) -> None:
        """Land an admission wave: map each row's shared COW prefix pages
        (ownership of the caller's pinned refs transfers to the slot),
        allocate fresh pages for the rest, and copy the dense rows' cells
        into the fresh pages only — shared pages are never written.

        Raises :exc:`PagePoolExhausted` *before* any mutation if the fresh
        pages don't fit, so the caller can reclaim leases and retry."""
        if not slots:
            return
        ps, cap = self.page_size, self.pages_per_slot
        consumed = ([self.cache_len] * len(slots) if consumed is None
                    else list(consumed))
        shared = ([[] for _ in slots] if shared is None
                  else [list(s) for s in shared])
        need = 0
        for c, sh in zip(consumed, shared):
            npages = min(-(-c // ps), cap)
            assert len(sh) * ps <= c and len(sh) <= npages
            need += npages - len(sh)
        if need > self.allocator.num_free:
            raise PagePoolExhausted(
                f"admission wave needs {need} pages, "
                f"{self.allocator.num_free} free")

        src, dst = [], []             # (row * cap + page index) -> page id
        for i, (slot, c, sh) in enumerate(zip(slots, consumed, shared)):
            assert not self._slot_pages.get(slot), \
                f"slot {slot} already holds pages"
            npages = min(-(-c // ps), cap)
            pages = list(sh)                        # refs transfer from caller
            for _ in range(npages - len(sh)):
                pages.append(self.allocator.alloc())
            src.extend(i * cap + j for j in range(len(sh), npages))
            dst.extend(pages[len(sh):npages])
            self._slot_pages[slot] = pages
            self._pt_host[slot, :npages] = pages
            self._pt_host[slot, npages:] = 0
        self._pt_dirty = True
        if dst:
            self._scatter_rows(single_caches, self._index(src),
                               self._index(dst))
        self._insert_dense(self._index(slots), single_caches)
        self.sync_page_table()

    def _scatter_rows(self, singles, src: torch.Tensor, dst: torch.Tensor):
        """Copy pages ``src`` of the wave's dense rows (row-major: row i's
        page j is ``i * pages_per_slot + j``) into arena pages ``dst``."""
        int8 = self.kv_dtype == "int8"
        ps = self.page_size
        rows_prefix = [s["prefix"] for s in singles]
        rows_block = [s["block"] for s in singles]
        for li, sub in enumerate(self.cache["prefix"]):
            for name in ("k", "v") if "k" in sub else ():
                rows = torch.cat([r[li][name].reshape(-1, ps, *r[li][name]
                                                      .shape[2:])
                                  for r in rows_prefix])[src]
                self._write_pages(sub, name, rows, dst, None, int8)
        for pos, sub in (self.cache.get("block") or {}).items():
            for name in ("k", "v") if "k" in sub else ():
                rows = torch.cat([r[pos][name].reshape(
                    r[pos][name].shape[0], -1, ps, *r[pos][name].shape[3:])
                    for r in rows_block], dim=1)[:, src]
                self._write_pages(sub, name, rows, dst, slice(None), int8)

    def _insert_dense(self, slots: torch.Tensor, singles) -> None:
        """Copy the wave's dense per-slot leaves (cross KV) into ``slots``."""
        for li, sub in enumerate(self.cache["prefix"]):
            for name, leaf in sub.items():
                if name not in ARENA_KEYS:
                    leaf[slots] = torch.cat([r["prefix"][li][name]
                                             for r in singles]).to(leaf.dtype)
        for pos, sub in (self.cache.get("block") or {}).items():
            for name, leaf in sub.items():
                if name not in ARENA_KEYS:
                    leaf[:, slots] = torch.cat(
                        [r["block"][pos][name] for r in singles],
                        dim=1).to(leaf.dtype)

    @staticmethod
    def _write_pages(sub, name, rows, dst, lead, int8):
        idx = (dst,) if lead is None else (lead, dst)
        if int8:
            q, sc = quantize_kv_int8(rows)
            sub[name][idx] = q
            sub[name + "_scale"][idx] = sc
        else:
            sub[name][idx] = rows.to(sub[name].dtype)

    def read(self, slot: int):
        """A slot's pages gathered back into a dense batch=1 cache row in
        the dense dtype (int8 pages dequantised); never-allocated table
        entries read as zeros, as a dense row starts from zeros.  Dense
        per-slot leaves (cross KV) are copied out of the slot."""
        pages = self._slot_pages.get(slot, [])
        ps, cap = self.page_size, self.pages_per_slot
        ids = self._index(pages)

        def gather(sub, name, stacked):
            leaf = sub[name]
            rows = leaf[:, ids] if stacked else leaf[ids]
            if name + "_scale" in sub:
                sc = sub[name + "_scale"]
                rows = rows.float() * (sc[:, ids] if stacked
                                       else sc[ids])[..., None]
            shape = list(leaf.shape)
            ax = 1 if stacked else 0
            shape[ax] = cap
            out = torch.zeros(shape, dtype=self._dense_dtype,
                              device=self.device)
            if stacked:
                out[:, :len(pages)] = rows.to(self._dense_dtype)
                return out.reshape(shape[0], 1, cap * ps, *shape[3:])
            out[:len(pages)] = rows.to(self._dense_dtype)
            return out.reshape(1, cap * ps, *shape[2:])

        def row(sub, stacked):
            out = {n: (leaf[:, slot:slot + 1] if stacked
                       else leaf[slot:slot + 1]).clone()
                   for n, leaf in sub.items() if n not in ARENA_KEYS}
            out.update({n: gather(sub, n, stacked)
                        for n in ("k", "v") if n in sub})
            return out

        out: Dict[str, Any] = {"prefix": [row(sub, False)
                                          for sub in self.cache["prefix"]]}
        out["block"] = ({pos: row(sub, True)
                         for pos, sub in self.cache["block"].items()}
                        if self.cache.get("block") is not None else None)
        return out

    # ------------------------------------------------------------------ #
    # decode-capacity planning (lazy tail allocation + COW splits)
    # ------------------------------------------------------------------ #
    def ensure_decode_capacity(self, slot_positions: Dict[int, int],
                               k_steps: int) -> bool:
        """Make every page the next decode block will write exclusively
        owned.  ``slot_positions`` maps live slot -> absolute position of
        its ``last_token`` (the block writes KV at positions
        ``pos .. pos+k-1``).  New tail pages are allocated lazily at
        page-boundary crossings; a ring wrap that lands a write on a
        ``refcount > 1`` page triggers a COW split (one-page device copy).
        Returns False — with no partial effects — if the arena can't supply
        the fresh pages; the engine then runs its pressure ladder and
        retries.  The device page table is current when this returns
        True."""
        ps, cap = self.page_size, self.pages_per_slot
        plans = []                                  # (slot, idx, src|None)
        for slot, pos in slot_positions.items():
            pages = self._slot_pages.get(slot)
            if pages is None:
                continue
            cur_len = len(pages)
            seen = set()
            for pg in range(pos // ps, (pos + k_steps - 1) // ps + 1):
                idx = pg % cap
                if idx in seen:
                    continue
                seen.add(idx)
                if idx < cur_len:
                    page = pages[idx]
                    if self.allocator.refcount(page) > 1:
                        plans.append((slot, idx, page))
                elif idx == cur_len:
                    plans.append((slot, idx, None))
                    cur_len += 1
                else:
                    raise AssertionError(
                        f"slot {slot}: non-contiguous page growth "
                        f"(idx {idx} > {cur_len})")
        if len(plans) > self.allocator.num_free:
            return False
        src_ids, dst_ids = [], []
        for slot, idx, src in plans:
            new = self.allocator.alloc()
            pages = self._slot_pages[slot]
            if src is None:
                assert idx == len(pages)
                pages.append(new)
            else:
                # COW split: the old page stays with its other owners
                self.allocator.decref(src)
                pages[idx] = new
                src_ids.append(src)
                dst_ids.append(new)
                self.allocator.stats.cow_splits += 1
            self._pt_host[slot, idx] = new
            self._pt_dirty = True
        if src_ids:
            self._copy_pages(self._index(src_ids), self._index(dst_ids))
        self.sync_page_table()
        return True

    def _copy_pages(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """COW split: copy whole pages (every arena leaf) src -> dst."""
        for sub, stacked in _arena_leaves(self.cache):
            for name, leaf in sub.items():
                if name not in ARENA_KEYS:
                    continue
                if stacked:
                    leaf[:, dst] = leaf[:, src]
                else:
                    leaf[dst] = leaf[src]

    # ------------------------------------------------------------------ #
    def single_cache_zeros(self):
        """Dense batch=1 zeros row, **read-only** (see
        :meth:`SlotKVPool.single_cache_zeros`) — prefill stays dense
        whatever the pool's layout; pagination happens at the commit."""
        if self._zeros is None:
            self._zeros = init_cache(self.cfg, 1, self.cache_len,
                                     ctx_len=self.ctx_len,
                                     dtype=self._dense_dtype,
                                     device=self.device)
        return self._zeros

    @property
    def nbytes(self) -> int:
        return tree_bytes(self.cache)
