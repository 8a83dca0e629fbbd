"""The port's paged KV slice against the JAX package on the CPU: the paged
attention's plain version (against the reference's oracle, its CPU op and
its Pallas kernel in interpret mode), int8 KV quantisation, the copied LRU
and prefix cache, seeded op walks over the page allocator and the paged
pool, and the engine — paged fp and int8, shared-prefix COW admission, the
dense layout with the prefix cache — against the JAX engine given the same
weights and arguments.

Inputs come from numpy seeds.  Tolerances: attention in float32 atol 2e-5 /
rtol 1e-3 (as ``tests/test_kernels.py``: the same sums in another order);
int8 quantisation and everything host-side (page ids, refcounts, counters,
greedy tokens) exact; engine logprobs atol 1e-4 (float32 through a whole
reduced model).
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import lru as jlru
from repro.core import paged_kv as jpaged
from repro.core import prefix_cache as jprefix
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.quant_matmul import quantize_kv_int8 as jax_quantize
from repro.models import build_model
from repro.serving.tokenizer import ByteTokenizer
from repro_torch.configs import get_config
from repro_torch.core import lru, paged_kv, prefix_cache
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import Request, SamplingParams
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import TILE_KEYS
from repro_torch.kernels.paged_attention import (paged_attention_plain,
                                                 paged_attention_split_plain,
                                                 split_cells)
from repro_torch.kernels.quant_matmul import quantize_kv_int8
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from test_torch_kernels import _paged_case
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-5, rtol=1e-3)
TOK = ByteTokenizer()


def _np(t):
    return t.detach().numpy()


# --------------------------------------------------------------------------- #
# paged attention: plain version vs the reference's oracle, op and kernel
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("ps,p,h,hkv,d", [(4, 6, 14, 2, 64),
                                          (8, 3, 8, 2, 32)])
def test_paged_plain_matches_jax(int8, ps, p, h, hkv, d):
    """Rows 0 and 1 share pages, row 2 has wrapped, every row's unallocated
    tail points at reserved page 0 (noise, never read).  Also the port's
    own oracle against the reference's."""
    args, kw = _paged_case("cpu", torch.float32, b=4, ps=ps, p=p, h=h,
                           hkv=hkv, d=d, int8=int8, seed=3)
    q, k, v, table, pos = args
    assert bool((table[0, :4] == table[1, :4]).all())
    assert int(pos[2]) >= p * ps and bool((table[3] == 0).any())
    got = _np(paged_attention_plain(*args, **kw))
    jargs = [_np(a) for a in args]
    jkw = {n: _np(t) for n, t in kw.items()}
    np.testing.assert_allclose(got, np.asarray(
        jref.paged_attention_ref(*jargs, **jkw)), **F32)
    np.testing.assert_allclose(got, np.asarray(
        jops.paged_attention(*jargs, **jkw)), **F32)
    np.testing.assert_allclose(got, np.asarray(paged_attention_pallas(
        *jargs, **jkw, interpret=True)), **F32)
    np.testing.assert_array_equal(_np(ops.paged_attention(*args, **kw)), got)
    np.testing.assert_allclose(_np(tref.paged_attention_ref(*args, **kw)),
                               np.asarray(jref.paged_attention_ref(
                                   *jargs, **jkw)), **F32)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("form", ["one split", "three splits", "many splits",
                                  "short row"])
def test_paged_split_plain_matches_jax(int8, form):
    """The kernel's split-pages algorithm (live cells cut on tile
    boundaries, 32-cell tiles scored whole, int8 scales folded into the
    score and into P, splits merged in index order) against the
    reference's oracle and its Pallas kernel in interpret mode.  Every case
    has a wrapped row (2) and rows sharing prefix pages (0, 1); ``short
    row`` leaves row 3 a single live cell, so all its splits but one are
    empty."""
    args, kw = _paged_case("cpu", torch.float32, b=4, ps=8, p=12, h=14,
                           hkv=2, d=32, int8=int8, seed=5)
    q, k, v, table, pos = args
    if form == "short row":
        pos[3] = 0
    assert int(pos[2]) >= table.shape[1] * k.shape[1]
    assert bool((table[0, :4] == table[1, :4]).all())
    n = {"one split": 1, "three splits": 3, "many splits": 40,
         "short row": 8}[form]
    got = _np(paged_attention_split_plain(*args, n, **kw))
    jargs = [_np(a) for a in args]
    jkw = {name: _np(t) for name, t in kw.items()}
    np.testing.assert_allclose(got, np.asarray(
        jref.paged_attention_ref(*jargs, **jkw)), **F32)
    np.testing.assert_allclose(got, np.asarray(paged_attention_pallas(
        *jargs, **jkw, interpret=True)), **F32)


@pytest.mark.parametrize("total", [16, 96, 2048])
@pytest.mark.parametrize("n_splits", [1, 3, 32, 200])
def test_paged_split_cells_cover_each_live_cell_once(total, n_splits):
    """Each live cell of every row (position 0, mid-table, the last cell,
    wrapped) falls in exactly one split, on tile boundaries, and no split
    reaches a dead cell."""
    for pos in sorted({0, 1, 31, 32, total // 2, total - 1, total,
                       total + 37}):
        live = total if pos >= total else pos + 1
        owner = np.zeros(total, int)
        for i in range(n_splits):
            lo, hi = split_cells(pos, total, i, n_splits)
            assert lo % TILE_KEYS == 0 and lo <= hi <= live
            assert hi == lo or hi == live or hi % TILE_KEYS == 0
            owner[lo:hi] += 1
        assert (owner[:live] == 1).all() and not owner[live:].any()


def test_quantize_kv_int8_bit_identical():
    """Random rows, exact .5 ties (half to even), clipped and all-zero
    rows: int8 values and scales equal the reference's bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 9, 2, 64)).astype(np.float32) * 3
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]           # scale 1: ties
    x[0, 0, 0, 4:] = 0.25
    x[0, 1] = 0.0                                      # absmax 0
    for arr in (x, x.astype(jnp.bfloat16).astype(np.float32)):
        q, s = quantize_kv_int8(torch.from_numpy(arr))
        jq, js = jax_quantize(arr)
        np.testing.assert_array_equal(_np(q), np.asarray(jq))
        np.testing.assert_array_equal(_np(s), np.asarray(js))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert list(_np(q)[0, 0, 0, :4]) == [127, 0, 2, -2]


# --------------------------------------------------------------------------- #
# the copied LRU and prefix cache give the reference's answers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(3))
def test_lru_matches_reference(seed):
    """A seeded walk of puts (some over budget), gets, evictions and
    discards: the same keys, bytes, stats and eviction callbacks."""
    rng = random.Random(seed)
    budget = rng.randint(200, 1200)
    evicted = ([], [])
    caches = (lru.LRUCache(budget, on_evict=lambda k, v: evicted[0].append(k)),
              jlru.LRUCache(budget, on_evict=lambda k, v: evicted[1].append(k)))
    for _ in range(80):
        op = rng.choice(("put", "put", "get", "evict", "discard"))
        key, nbytes = f"k{rng.randint(0, 9)}", rng.randint(1, 400)
        out = []
        for c in caches:
            out.append({"put": lambda: c.put(key, key, nbytes),
                        "get": lambda: c.get(key),
                        "evict": c.evict_lru,
                        "discard": lambda: c.discard(key)}[op]())
        assert out[0] == out[1]
        assert list(caches[0].keys()) == list(caches[1].keys())
        assert caches[0].nbytes == caches[1].nbytes <= budget
        assert vars(caches[0].stats) == vars(caches[1].stats)
    assert evicted[0] == evicted[1]
    # the eviction order of tests/test_caches.py
    for mod in (lru, jlru):
        c = mod.LRUCache(max_bytes=30)
        for k, v in (("a", 1), ("b", 2), ("c", 3)):
            c.put(k, v, 10)
        assert c.get("a") == 1
        c.put("d", 4, 10)
        assert "b" not in c and {"a", "c", "d"} <= set(c.keys())


@pytest.mark.parametrize("block", [1, 2, 4, 8])
def test_prefix_cache_matches_reference(block):
    """Longest block-aligned match over seeded inserts and queries, the
    paper-faithful mode, the max_len cap, salts, rolling keys and exact
    entries: the port's copy answers as the reference does."""
    rng = np.random.default_rng(block)
    ours = prefix_cache.TextPrefixCache(block_size=block, max_bytes=1 << 30)
    ref = jprefix.TextPrefixCache(block_size=block, max_bytes=1 << 30)
    for i in range(12):
        toks = [int(t) for t in rng.integers(0, 4, rng.integers(1, 40))]
        salt = b"A" if i % 5 == 4 else b""
        assert ours.insert(toks, f"v{i}", 1, salt=salt) == \
            ref.insert(toks, f"v{i}", 1, salt=salt)
        assert ours.key_for(toks, salt=salt) == ref.key_for(toks, salt=salt)
    for _ in range(40):
        query = [int(t) for t in rng.integers(0, 4, rng.integers(1, 40))]
        cap = int(rng.integers(1, 41))
        for salt in (b"", b"A", b"B"):
            assert ours.lookup(query, salt=salt, max_len=cap) == \
                ref.lookup(query, salt=salt, max_len=cap)
    for c in (ours, ref):
        c.insert_exact([1, 2, 3], "snap", 1)
    assert ours.take_exact([1, 2, 3]) == ref.take_exact([1, 2, 3]) == "snap"
    assert ours.take_exact([1, 2, 3]) is ref.take_exact([1, 2, 3]) is None
    assert vars(ours.stats) == vars(ref.stats) and len(ours) == len(ref)


# --------------------------------------------------------------------------- #
# seeded op walks over the allocator and the pool, on both packages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_page_allocator_walk_matches_reference(seed):
    rng = random.Random(seed)
    num_pages, reserved = rng.randint(6, 24), rng.randint(0, 3)
    pair = (paged_kv.PageAllocator(num_pages, reserved),
            jpaged.PageAllocator(num_pages, reserved))
    owned = []
    for _ in range(150):
        op = rng.choice(("alloc", "alloc", "share", "free", "cow"))
        if op == "alloc":
            if pair[1].num_free:
                got = [a.alloc() for a in pair]
                assert got[0] == got[1]
                owned.append(got[0])
            else:
                for a, exc in zip(pair, (paged_kv.PagePoolExhausted,
                                         jpaged.PagePoolExhausted)):
                    with pytest.raises(exc):
                        a.alloc()
        elif op == "share" and owned:
            page = rng.choice(owned)
            for a in pair:
                a.incref(page)
            owned.append(page)
        elif op == "free" and owned:
            page = owned.pop(rng.randrange(len(owned)))
            for a in pair:
                a.decref(page)
        elif op == "cow" and owned:
            idx = next((i for i, p in enumerate(owned)
                        if pair[1].refcount(p) > 1), None)
            if idx is not None and pair[1].num_free:
                new = [a.alloc() for a in pair]
                assert new[0] == new[1]
                for a in pair:
                    a.decref(owned[idx])
                owned[idx] = new[0]
        assert pair[0]._ref == pair[1]._ref
        assert pair[0]._free == pair[1]._free
        assert vars(pair[0].stats) == vars(pair[1].stats)


def _random_rows(cfg, cache_len, rng, n):
    """n batch=1 dense cache rows of seeded noise, as numpy trees."""
    shapes = tmodel.init_cache(cfg, 1, cache_len, device="meta")
    return [tmodel.tree_map(
        lambda a: rng.standard_normal(tuple(a.shape)).astype(np.float32),
        shapes) for _ in range(n)]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_paged_pool_walk_matches_reference(kv_dtype):
    """Allocate, insert waves (some sharing a live slot's prefix pages COW),
    decode capacity across page boundaries and through ring wraps that
    split shared pages, and frees — on both packages.  Page tables,
    refcounts, PageStats, occupancy and every slot's gathered row agree
    (the row exactly for fp, within one int8 rounding's dequantisation
    for int8: both sides hold the same int8 values and scales)."""
    cfg, jcfg = get_config("qwen3-0.6b-toy"), jax_get_config("qwen3-0.6b-toy")
    cache_len, ps, max_batch = 32, 8, 3
    ours = paged_kv.PagedKVPool(cfg, max_batch, cache_len, page_size=ps,
                                kv_dtype=kv_dtype, dtype=torch.float32,
                                device="cpu")
    ref = jpaged.PagedKVPool(jcfg, max_batch, cache_len, page_size=ps,
                             kv_dtype=kv_dtype, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    prng = random.Random(11)
    live = {}                                  # slot -> position

    def same():
        np.testing.assert_array_equal(ours._pt_host, ref._pt_host)
        if not ours._pt_dirty:          # the device copy, once synced
            np.testing.assert_array_equal(_np(ours.cache["page_table"]),
                                          ours._pt_host)
        assert ours.allocator._ref == ref.allocator._ref
        assert vars(ours.stats) == vars(ref.stats)
        assert ours.page_occupancy() == ref.page_occupancy()
        for slot in live:
            a = list(tmodel.tree_leaves(ours.read(slot)))
            b = list(jax.tree.leaves(ref.read(slot)))
            for x, y in zip(a, b):
                np.testing.assert_allclose(_np(x), np.asarray(y), atol=1e-6)

    for step in range(14):
        if step % 4 == 3 and live:                 # retire one slot
            slot = prng.choice(sorted(live))
            del live[slot]
            ours.free(slot)
            ref.free(slot)
        elif ours.num_free and step % 4 != 2:      # admit one or two rows
            k = min(ours.num_free, prng.choice((1, 2)))
            slots = [ours.allocate() for _ in range(k)]
            assert slots == [ref.allocate() for _ in range(k)]
            consumed = [prng.randint(1, cache_len) for _ in slots]
            shared = [[] for _ in slots]
            donor = next(iter(live), None)
            if donor is not None and consumed[0] > ps:
                n = min(len(ours.slot_pages(donor)), (consumed[0] - 1) // ps)
                shared[0] = list(ours.slot_pages(donor)[:n])
                ours.incref_pages(shared[0])
                ref.incref_pages(shared[0])
            rows = _random_rows(cfg, cache_len, rng, k)
            ours.insert_many(slots, [tmodel.tree_map(torch.from_numpy, r)
                                     for r in rows], consumed, shared)
            ref.insert_many(slots, [jax.tree.map(jnp.asarray, r)
                                    for r in rows], consumed, shared)
            live.update((s, c - 1) for s, c in zip(slots, consumed))
        else:                                      # a decode block of 5
            assert ours.ensure_decode_capacity(live, 5) == \
                ref.ensure_decode_capacity(live, 5)
            live = {s: p + 5 for s, p in live.items()}
        same()
    assert ours.stats.cow_splits > 0 and ours.stats.shares > 0
    assert ours.nbytes == ref.nbytes


# --------------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          "cpu")


def _prompts():
    """Five prompts, three sharing a 40-token prefix, one longer than the
    32-token prefill chunk after it."""
    rng = np.random.default_rng(0)
    base = [int(t) for t in rng.integers(1, 256, size=40)]
    return [base + [int(t) for t in rng.integers(1, 256, size=n)]
            for n in (5, 9, 30)] + \
        [[int(t) for t in rng.integers(1, 256, size=n)] for n in (3, 17)]


def _run_pair(weights, sampling=None, **kw):
    jcfg, tcfg, jp, tp = weights
    args = dict(max_batch=2, cache_len=128, prefill_chunk=32,
                speculative_fill=False, **kw)
    je = JaxEngine(jcfg, jp, **args)
    te = InferenceEngine(tcfg, tp, device="cpu", **args)
    sampling = sampling or [{"max_tokens": m} for m in (12, 7, 10, 16, 1)]
    jr = [JaxRequest(prompt_tokens=p, sampling=JaxSampling(**s))
          for p, s in zip(_prompts(), sampling)]
    tr = [Request(prompt_tokens=p, sampling=SamplingParams(**s))
          for p, s in zip(_prompts(), sampling)]
    je.generate(jr)
    te.generate(tr)
    for a, b in zip(jr, tr):
        assert b.output_tokens == a.output_tokens
        assert b.cached_prefix_len == a.cached_prefix_len
        assert b.finish_reason.value == a.finish_reason.value
    assert vars(te.prefix_cache.stats) == vars(je.prefix_cache.stats)
    return je, te, jr, tr


@pytest.mark.parametrize("page_size", [128, 16])
def test_paged_engine_matches_reference_and_dense(weights, page_size):
    """Paged fp at one page per slot and at 16-token pages: greedy tokens,
    prefix hits, page ids and allocator counters equal the JAX engine's,
    and the tokens equal the port's own dense layout."""
    je, te, _, tr = _run_pair(weights, kv_layout="paged",
                              kv_page_size=page_size)
    assert any(r.cached_prefix_len for r in tr)
    assert vars(te.pool.stats) == vars(je.pool.stats)
    assert te.pool.page_occupancy() == je.pool.page_occupancy()
    assert te.pool.allocator._free == je.pool.allocator._free
    dense = InferenceEngine(weights[1], weights[3], device="cpu", max_batch=2,
                            cache_len=128, prefill_chunk=32)
    dr = [Request(prompt_tokens=p, sampling=SamplingParams(max_tokens=m))
          for p, m in zip(_prompts(), (12, 7, 10, 16, 1))]
    dense.generate(dr)
    assert [r.output_tokens for r in dr] == [r.output_tokens for r in tr]


def test_paged_int8_engine_matches_reference(weights):
    """Int8 pages: the same greedy tokens, and every step's logprobs (the
    first decode step's included) within 1e-4 of the JAX engine's."""
    lp = [{"max_tokens": m, "logprobs": True, "top_logprobs": 3}
          for m in (12, 7, 10, 16, 1)]
    je, te, jr, tr = _run_pair(weights, sampling=lp, kv_layout="paged",
                               kv_dtype="int8")
    assert vars(te.pool.stats) == vars(je.pool.stats)
    for a, b in zip(jr, tr):
        assert len(b.output_logprobs) == len(a.output_logprobs) > 0
        for (la, ta), (lb, tb) in zip(a.output_logprobs, b.output_logprobs):
            assert lb == pytest.approx(la, abs=1e-4)
            np.testing.assert_allclose([x for _, x in tb], [x for _, x in ta],
                                       atol=1e-4)


def test_dense_prefix_cache_matches_reference(weights):
    """Dense layout with the prefix cache on: hits, misses, insertions and
    matched lengths equal the JAX engine's, tokens identical."""
    je, te, _, tr = _run_pair(weights)
    assert te.prefix_cache.stats.hits > 0
    assert len(te.prefix_cache) == len(je.prefix_cache)


def test_cow_prefix_hit_does_zero_copies(weights):
    """The pair of ``tests/test_paged_kv.py``'s COW gate on both engines:
    the second request maps the cached prefix pages, ``full_copies`` stays
    0, the allocator counters equal the reference's, and once both retire
    every page is free or held only by the prefix cache."""
    jcfg, tcfg, jp, tp = weights
    args = dict(max_batch=2, cache_len=128, kv_layout="paged", kv_page_size=16)
    engines = (JaxEngine(jcfg, jp, **args),
               InferenceEngine(tcfg, tp, device="cpu", **args))
    base = "shared prefix " * 8
    out = []
    for eng, req_cls, samp_cls in ((engines[0], JaxRequest, JaxSampling),
                                   (engines[1], Request, SamplingParams)):
        reqs = [req_cls(prompt_tokens=TOK.encode(base + tail),
                        sampling=samp_cls(max_tokens=6))
                for tail in ("tail one", "tail TWO!")]
        eng.generate(reqs[:1])
        eng.generate(reqs[1:])
        out.append(reqs)
    (j1, j2), (t1, t2) = out
    assert t2.cached_prefix_len == j2.cached_prefix_len >= 64
    assert [t1.output_tokens, t2.output_tokens] == \
        [j1.output_tokens, j2.output_tokens]
    je, te = engines
    assert vars(te.pool.stats) == vars(je.pool.stats)
    assert te.pool.stats.full_copies == 0 and te.pool.stats.shares > 0
    occ = te.pool.page_occupancy()
    assert occ == je.pool.page_occupancy()
    assert occ["pinned"] == 0 and occ["free"] + occ["reclaimable"] == \
        occ["total"]


def test_arena_below_full_capacity_is_refused(weights):
    """Arenas below full capacity are served now (the pressure ladder of
    ``tests/test_torch_preemption.py`` runs them); what stays refused is an
    arena with no page past the reserved ones and int8 KV on the dense
    layout."""
    tcfg, tp = weights[1], weights[3]
    small = InferenceEngine(tcfg, tp, device="cpu", max_batch=2,
                            cache_len=128, kv_layout="paged",
                            kv_page_size=16, kv_num_pages=12)
    assert small.pool.num_pages == 12
    assert small.pool.page_occupancy()["total"] == 12 - 2
    with pytest.raises(ValueError, match="reserved"):
        InferenceEngine(tcfg, tp, device="cpu", max_batch=2, cache_len=128,
                        kv_layout="paged", kv_page_size=16, kv_num_pages=2)
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine(tcfg, tp, device="cpu", kv_dtype="int8")
    full = paged_kv.PagedKVPool.full_capacity(2, 128, 16)
    eng = InferenceEngine(tcfg, tp, device="cpu", max_batch=2, cache_len=128,
                          kv_layout="paged", kv_page_size=16,
                          kv_num_pages=full)
    assert eng.pool.num_pages == full == 2 + 2 * 8
