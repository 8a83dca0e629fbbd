"""Slot-based decode cache pool + device-resident decode state (the dense
subset of the reference package's ``core/kv_cache.py``).

The decode batch has a *static* shape of ``max_batch`` slots over a
pre-allocated ring cache; requests occupy slots, admission fills free slots
at step boundaries, retirement frees them.  :class:`DecodeState` holds
everything the decode loop needs per slot — last sampled token, absolute
position, the per-request sampler state, media-context liveness, remaining
token budget, stop-token table and the live/frozen mask — as tensors on
the engine's device, so the engine's K-step decode block runs without the
host re-uploading state between tokens.

Unlike the reference (immutable arrays, donated through ``jit``), the port
updates in place: :func:`admit_decode_state` scatters into the state's
tensors, :meth:`SlotKVPool.insert_many` into the pool's cache, and the model
writes decode K/V into the pool's cache directly.  The frozen-slot rule of
the reference's ``select_cache_slots`` becomes a masked write inside the
attention layer (a frozen slot's cell is written with its old value, see
:mod:`repro_torch.models.layers`), and a Mamba layer writes a frozen
slot's ``conv``/``state`` rows back unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Set

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.sampling import keys_array
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import init_cache, tree_leaves, tree_map


def tree_bytes(tree: Any) -> int:
    """Bytes held by every tensor leaf of a cache tree (the prefix cache's
    LRU byte accounting)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


# --------------------------------------------------------------------------- #
# device-resident per-slot decode state
# --------------------------------------------------------------------------- #
@dataclass
class DecodeState:
    """Per-slot decode state on the engine's device, updated in place.
    ``stop_tokens`` is a fixed-width table padded with -1 (never a valid
    token id); ``active`` is the on-device finished-mask — a slot freezes
    when it samples a stop token or exhausts its budget, and stays frozen
    (masked cache writes, no position advance) until the host re-admits into
    the slot.  ``sample_key`` is the request's base PRNG key (two uint32
    words in int64); the sampler folds the token position into it per step
    (``fold_in(key, position)``), so one slot's stream never depends on its
    neighbours or on K."""

    last_token: torch.Tensor   # [B] int64 — input to the next decode step
    positions: torch.Tensor    # [B] int64 — absolute position of last_token
    temps: torch.Tensor        # [B] float32 — 0 = greedy
    top_p: torch.Tensor        # [B] float32 — 1 = off
    top_k: torch.Tensor        # [B] int64 — 0 = off
    min_p: torch.Tensor        # [B] float32 — 0 = off
    sample_key: torch.Tensor   # [B, 2] int64 — per-request base key words
    ctx_valid: torch.Tensor    # [B, T] bool — media context liveness
    budget: torch.Tensor       # [B] int64 — tokens left before LENGTH stop
    stop_tokens: torch.Tensor  # [B, S] int64 — per-slot stop ids, -1 pad
    active: torch.Tensor       # [B] bool — False: slot frozen/empty
    draft_tokens: torch.Tensor  # [B, K] int64 — staged speculative drafts
    draft_len: torch.Tensor    # [B] int64 — drafts staged this round (<= K)


def init_decode_state(max_batch: int, max_stop: int, *, ctx_len: int = 0,
                      spec_k: int = 0,
                      device: DeviceLike = None) -> DecodeState:
    """An all-empty state on ``device`` (``cuda`` unless the caller asks
    for another); ``ctx_len`` is the media context length (0: text),
    ``spec_k`` the most drafts a speculative round stages per slot."""
    device = resolve_device(device)

    def z(dtype, fill=0):
        return torch.full((max_batch,), fill, dtype=dtype, device=device)

    return DecodeState(
        last_token=z(torch.int64), positions=z(torch.int64),
        temps=z(torch.float32), top_p=z(torch.float32, 1.0),
        top_k=z(torch.int64), min_p=z(torch.float32),
        sample_key=torch.zeros((max_batch, 2), dtype=torch.int64,
                               device=device),
        ctx_valid=torch.zeros((max_batch, max(ctx_len, 1)), dtype=torch.bool,
                              device=device),
        budget=z(torch.int64),
        stop_tokens=torch.full((max_batch, max_stop), -1, dtype=torch.int64,
                               device=device),
        active=z(torch.bool, False),
        draft_tokens=torch.zeros((max_batch, max(spec_k, 1)),
                                 dtype=torch.int64, device=device),
        draft_len=z(torch.int64))


def admit_decode_state(state: DecodeState, slots: Sequence[int],
                       **rows: Sequence) -> None:
    """Scatter one admission wave (k slots) into the decode state in place:
    ``rows`` maps each :class:`DecodeState` field to its k new values (host
    lists or arrays, uploaded here in one copy per field; ``sample_key``
    rows are uint32 ``[2]`` keys).  The slots' staged drafts are cleared,
    as in the reference."""
    dev = state.active.device
    idx = torch.as_tensor(list(slots), dtype=torch.int64, device=dev)
    for name, values in rows.items():
        dst = getattr(state, name)
        if name == "sample_key":
            values = keys_array(values)
        dst[idx] = torch.as_tensor(values, dtype=dst.dtype, device=dev)
    state.draft_tokens[idx] = 0
    state.draft_len[idx] = 0


# --------------------------------------------------------------------------- #
# speculative-decode rollback (dense ring here, paged arena in paged_kv)
# --------------------------------------------------------------------------- #
def gather_cells(cache, rows: torch.Tensor, cols: torch.Tensor, names):
    """Copies of the cells ``(rows[b, j], cols[b, j])`` of the leaves
    ``names`` of every layer, as ``[B, S, ...]`` (stacked block layers
    ``[L, B, S, ...]``) blocks in the reference's snapshot layout
    (``{"prefix": [...], "block": {...}}``)."""
    def g(sub, stacked):
        return {n: (sub[n][:, rows, cols] if stacked else sub[n][rows, cols])
                for n in sub if n in names}

    out = {"prefix": [g(sub, False) for sub in cache["prefix"]]}
    out["block"] = ({pos: g(sub, True) for pos, sub in cache["block"].items()}
                    if cache.get("block") is not None else None)
    return out


def restore_cells(cache, snap, rows: torch.Tensor, cols: torch.Tensor,
                  keep: torch.Tensor) -> None:
    """In place, for every leaf of ``snap`` (a :func:`gather_cells` tree of
    the same cells): each cell keeps its current value where ``keep``
    ([B, S] bool) is True and takes its snapshot back where it is False.
    The write is an indexed assignment without accumulation: the callers
    give every repeated index the same value (see theirs)."""
    b, s = keep.shape

    def r(sub, sn, stacked):
        for n, old in sn.items():
            leaf = sub[n]
            if stacked:
                cur = leaf[:, rows, cols]
                mask = keep.reshape((1, b, s) + (1,) * (cur.ndim - 3))
                leaf[:, rows, cols] = torch.where(mask, cur, old)
            else:
                cur = leaf[rows, cols]
                mask = keep.reshape((b, s) + (1,) * (cur.ndim - 2))
                leaf[rows, cols] = torch.where(mask, cur, old)

    for sub, sn in zip(cache["prefix"], snap["prefix"]):
        r(sub, sn, False)
    for pos, sub in (cache.get("block") or {}).items():
        r(sub, snap["block"][pos], True)


def _ring_rows(slots: torch.Tensor) -> torch.Tensor:
    return torch.arange(slots.shape[0], device=slots.device)[:, None] \
        .expand_as(slots)


def gather_ring_cells(cache, slots: torch.Tensor):
    """Snapshot the ring cells ``slots`` ([B, S] ring indices) of every
    ``k``/``v`` leaf: the speculative verifier's pre-forward copy of the
    cells its batched forward may overwrite (the reference's
    ``gather_ring_cells``).  Cross-attention ``xk``/``xv`` are read-only in
    decode and carry no per-position state."""
    return gather_cells(cache, _ring_rows(slots), slots, ("k", "v"))


def restore_ring_cells(cache, snap, slots: torch.Tensor,
                       keep: torch.Tensor) -> None:
    """Roll back the ring cells of rejected speculative positions in place
    (``keep`` [B, S]: True keeps the forward's cell, False restores the
    :func:`gather_ring_cells` snapshot).  A row's cells are consecutive
    ring positions (S <= cache_len), so no index repeats."""
    restore_cells(cache, snap, _ring_rows(slots), slots, keep)


# --------------------------------------------------------------------------- #
# cache rows: wave concatenation and per-row slices
# --------------------------------------------------------------------------- #
def _map_rows(fn_prefix, fn_block, caches: Sequence[Any]):
    first = caches[0]
    out = {"prefix": [
        {name: fn_prefix([c["prefix"][i][name] for c in caches])
         for name in first["prefix"][i]}
        for i in range(len(first["prefix"]))]}
    out["block"] = ({pos: {name: fn_block([c["block"][pos][name]
                                           for c in caches])
                           for name in sub}
                     for pos, sub in first["block"].items()}
                    if first.get("block") is not None else None)
    return out


def concat_cache_rows(singles: Sequence[Any]):
    """Concatenate k batch=1 caches into one fresh ``[k, ...]`` cache (prefix
    leaves batch on axis 0, stacked block leaves on axis 1).  The result
    owns new storage, so a prefill wave may write into it in place even
    when a row came from :meth:`SlotKVPool.single_cache_zeros`."""
    return _map_rows(lambda ts: torch.cat(ts, dim=0),
                     lambda ts: torch.cat(ts, dim=1), singles)


def slice_cache_row(cache, row: int):
    """One row of a ``[k, ...]`` wave cache as a batch=1 cache of *views*
    (no copy): the engine hands it back to the row's chunk job, whose next
    chunk concatenates it into a fresh wave cache.  A view pins the whole
    wave cache, so whatever keeps a row longer (a prefix-cache entry) stores
    ``tree_map(torch.clone, row)`` instead."""
    out = {"prefix": [tree_map(lambda a: a[row:row + 1], bp)
                      for bp in cache["prefix"]]}
    out["block"] = (tree_map(lambda a: a[:, row:row + 1], cache["block"])
                    if cache.get("block") is not None else None)
    return out


class SlotKVPool:
    """Fixed-capacity decode cache with slot allocation, on ``device``
    (``cuda`` unless the caller asks for another).  The pool owns
    ``self.cache``; the engine's decode steps write into it in place."""

    def __init__(self, cfg: ModelConfig, max_batch: int, cache_len: int, *,
                 ctx_len: int = 0, dtype=None, device: DeviceLike = None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.ctx_len = ctx_len
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, max_batch, cache_len, ctx_len=ctx_len,
                                dtype=dtype, device=self.device)
        self._free: List[int] = list(range(max_batch))[::-1]
        self._used: Set[int] = set()
        self._zeros: Optional[Any] = None

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

    def insert(self, slot: int, single_cache) -> None:
        """Install one batch=1 cache into a slot (a preemption snapshot's
        restore: the row read by :meth:`read` goes back bit for bit)."""
        self.insert_many([slot], [single_cache])

    def insert_many(self, slots: Sequence[int], single_caches) -> None:
        """Install an admission wave of batch=1 caches: one concatenation
        and one indexed copy per cache leaf, whatever the wave size."""
        if not slots:
            return
        idx = torch.as_tensor(list(slots), dtype=torch.int64,
                              device=self.device)
        many = concat_cache_rows(list(single_caches))
        for full, new in zip(self.cache["prefix"], many["prefix"]):
            for name in full:
                full[name][idx] = new[name].to(full[name].dtype)
        if self.cache.get("block") is not None:
            for pos, sub in self.cache["block"].items():
                for name in sub:
                    sub[name][:, idx] = many["block"][pos][name].to(
                        sub[name].dtype)

    def read(self, slot: int):
        """A copy of one slot's cache as a batch=1 cache (the pool's own
        tensors keep changing under later decode steps)."""
        out = {"prefix": [tree_map(lambda a: a[slot:slot + 1].clone(), bp)
                          for bp in self.cache["prefix"]]}
        out["block"] = (tree_map(lambda a: a[:, slot:slot + 1].clone(),
                                 self.cache["block"])
                        if self.cache.get("block") is not None else None)
        return out

    def single_cache_zeros(self):
        """One shared zeros batch=1 cache per pool, **read-only**.

        It is shared by every fresh prefill job and every padding row of a
        wave, so an in-place write into it — or into any view that aliases
        it — would corrupt every later prefill.  The same holds for every
        prefix-cache entry, which resumed prefill jobs start from.  Nothing
        writes into either: waves run on the fresh tensors of
        :func:`concat_cache_rows`, and decode writes only into the pool's
        own ``self.cache``."""
        if self._zeros is None:
            self._zeros = init_cache(self.cfg, 1, self.cache_len,
                                     ctx_len=self.ctx_len, device=self.device)
        return self._zeros

    @property
    def nbytes(self) -> int:
        return tree_bytes(self.cache)
