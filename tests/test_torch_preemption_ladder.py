"""The page-pressure ladder, the pools' snapshot primitives, preemption
with media, and the card's preemption scenario: the second half of
``tests/test_torch_preemption.py`` (its harness imported from there).

Against the JAX package's engine on the CPU, given the same weights:
greedy tokens, page ids, refcounts and :class:`PageStats` step by step
for the ladder of ``tests/test_paged_kv.py`` (rung 1 at ``kv_num_pages=2
+ 2 * 8``, a rung-2 round both engines finish, a rung-3 failure);
``PagedKVPool.adopt`` and the dense snapshot restore bit for bit; with
media (``tests/test_mllm_serving.py``) the encoder and cache counters
through preemption, a lost snapshot and cross-KV leases under pressure.

Where the two differ on purpose: a rung-2 victim re-admitted at once needs
at its commit the pages its eviction freed, minus what the other slots
took meanwhile.  The reference fails that commit; the port stages it until
retirements free the pages (``test_staged_commit_...``).

The ``gpu`` test runs the preemption scenario on the card, through the
decode kernel (dense snapshot restore) and the paged kernel (adopt and
resume), and skips without one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.kv_cache import SlotKVPool, tree_bytes
from repro_torch.core.paged_kv import PagedKVPool
from repro_torch.core.request import FinishReason, Request, SamplingParams
from repro_torch.models.model import tree_leaves, tree_map
from test_torch_preemption import (BATCH, LAYOUTS, PAGED, TOK,  # noqa: F401
                                   URGENT, Pair, _bridge, _same, jx,
                                   quiet_ladder, weights)
from torch_threads import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------- #
# the pressure ladder (tests/test_paged_kv.py:232 and beyond)
# --------------------------------------------------------------------------- #
def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 250, n)]


def _ladder(weights, lens, max_tokens, *, max_batch, num_pages, **kw):
    p = Pair(weights, max_batch=max_batch, cache_len=128, prefill_chunk=32,
             kv_num_pages=num_pages, **PAGED, **kw)
    reqs = [p.req(tokens=_prompt(n, i), sampling={"max_tokens": m})
            for i, (n, m) in enumerate(zip(lens, max_tokens))]
    for r in reqs:
        p.add(r)
    p.run()
    for r in reqs:
        _same(*r)
    return p, [t for _, t in reqs]


def test_pressure_ladder_rung1_matches_reference(weights):
    """Reserved + exactly two slots' pages: prefix-cache leases are
    reclaimed, every request finishes, tokens equal the dense layout's."""
    p, tr = _ladder(weights, (28,) * 4, (8,) * 4, max_batch=2,
                    num_pages=2 + 2 * 8)
    assert all(r.finish_reason is FinishReason.LENGTH for r in tr)
    assert p.te.scheduler.stats.preemptions == 0
    assert p.te.pool.page_occupancy()["pinned"] == 0


def test_pressure_ladder_rung2_matches_reference(weights):
    """Three slots over 10 allocatable pages: rung 2 preempts the slot
    holding the most pages (no snapshot), which re-prefills its history
    once short requests retire — twice, the same steps in both engines."""
    p, tr = _ladder(weights, (20, 20, 20) + (4,) * 6, (70, 50, 30) + (3,) * 6,
                    max_batch=3, num_pages=12)
    stats = p.te.scheduler.stats
    assert stats.preemptions == 2 and stats.resumed == 0
    assert all(r.finish_reason is FinishReason.LENGTH for r in tr)
    assert sum(r.preempt_count for r in tr) == 2
    occ = p.te.pool.page_occupancy()
    assert occ == p.je.pool.page_occupancy() and occ["pinned"] == 0


def test_rung3_fails_one_request_and_the_others_finish(weights):
    """One slot over 4 allocatable pages (64 tokens): the request that
    outgrows the arena alone fails with the typed error; the others
    finish, in both engines."""
    p, tr = _ladder(weights, (20, 10, 12), (100, 5, 8), max_batch=1,
                    num_pages=6)
    assert tr[0].finish_reason is FinishReason.ERROR
    assert tr[0].error == "KV page pool exhausted (6 pages)"
    assert 0 < tr[0].num_generated < 100
    assert [r.finish_reason for r in tr[1:]] == [FinishReason.LENGTH] * 2
    assert p.te.scheduler.stats.failed == 1
    assert p.te.pool.page_occupancy()["pinned"] == 0


def test_staged_commit_finishes_a_victim_the_reference_fails(weights):
    """Two long requests over 8 allocatable pages: rung 2 evicts one, the
    free slot re-admits it at once, and its re-prefill needs more pages
    than are free.  The reference fails it at the commit; the port stages
    the commit until the other long request retires — every request
    finishes."""
    jcfg, tcfg, jp, tp, jx = weights
    args = dict(max_batch=3, cache_len=128, prefill_chunk=32, **PAGED)
    lens, maxt = (30, 30, 5, 5, 5, 5), (60, 60, 4, 4, 4, 4)

    def reqs(make_req, make_samp):
        return [make_req(prompt_tokens=_prompt(n, i),
                         sampling=make_samp(max_tokens=m))
                for i, (n, m) in enumerate(zip(lens, maxt))]

    je = jx.Engine(jcfg, jp, speculative_fill=False, kv_num_pages=10,
                   **args)
    jr = je.generate(reqs(jx.Request, jx.SamplingParams))
    assert [r.finish_reason.value for r in jr].count("error") == 1
    assert "admission commit failed" in next(r.error for r in jr
                                             if r.error)
    te = InferenceEngine(tcfg, tp, device="cpu", speculative_fill=False,
                         kv_num_pages=10, **args)
    tr = te.generate(reqs(Request, SamplingParams))
    assert all(r.finish_reason in (FinishReason.LENGTH, FinishReason.STOP)
               for r in tr)
    assert te.scheduler.stats.preemptions == je.scheduler.stats.preemptions
    assert not te._staged
    # requests never evicted decode as in a full-capacity arena and as in
    # the reference; a re-prefilled history rounds differently from
    # incremental decode, so the victim's later tokens may differ
    full = InferenceEngine(tcfg, tp, device="cpu", **args)
    fr = full.generate(reqs(Request, SamplingParams))
    kept = [i for i, r in enumerate(tr) if not r.preempt_count]
    assert len(kept) == len(tr) - 1
    for i in kept:
        assert tr[i].output_tokens == fr[i].output_tokens
        if jr[i].finish_reason is not FinishReason.ERROR:
            assert tr[i].output_tokens == jr[i].output_tokens
    assert te.pool.page_occupancy()["pinned"] == 0


# --------------------------------------------------------------------------- #
# pools: snapshot restore, adopt, the dense per-slot leaves
# --------------------------------------------------------------------------- #
def test_adopt_keeps_page_ids_refcounts_and_stats(weights):
    """Pool walk on both packages: insert a row, snapshot its pages by
    reference (incref), free the slot, adopt the pages into another slot;
    page tables, refcounts, free lists and counters stay equal, and the
    adopted slot reads back the inserted row bit for bit."""
    jcfg, tcfg, jx = weights[0], weights[1], weights[4]
    jax = jx.jax
    jpool = jx.PagedKVPool(jcfg, 3, 64, page_size=16)
    tpool = PagedKVPool(tcfg, 3, 64, page_size=16, device="cpu")
    rng = np.random.default_rng(0)
    rows = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                        jax.tree.map(np.asarray, jpool.single_cache_zeros()))
    trow = {"prefix": [{k: torch.from_numpy(v) for k, v in sub.items()}
                       for sub in rows["prefix"]],
            "block": ({pos: {k: torch.from_numpy(v) for k, v in sub.items()}
                       for pos, sub in rows["block"].items()}
                      if rows.get("block") else None)}
    for pool, row in ((jpool, rows), (tpool, trow)):
        slot = pool.allocate()
        pool.insert_many([slot], [row], consumed=[40])
        pages = list(pool.slot_pages(slot))
        nonkv = pool.read_nonkv(slot)
        pool.incref_pages(pages)
        pool.free(slot)
        pool.allocate()
        target = pool.allocate()
        pool.adopt(target, pages, nonkv)
    assert tpool._slot_pages == jpool._slot_pages
    assert tpool.allocator._ref == jpool.allocator._ref
    assert tpool.allocator._free == jpool.allocator._free
    assert vars(tpool.stats) == vars(jpool.stats)
    assert np.array_equal(tpool.cache["page_table"].numpy(),
                          np.asarray(jpool.cache["page_table"]))
    got = list(tree_leaves(tpool.read(target)))
    want = jax.tree.leaves(jpool.read(target))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dense_snapshot_restore_is_bit_exact(weights):
    """``SlotKVPool.insert`` puts back what ``read`` took, bit for bit, and
    the pool's bytes equal the reference's."""
    jcfg, tcfg, jx = weights[0], weights[1], weights[4]
    pool = SlotKVPool(tcfg, 2, 64, device="cpu")
    g = torch.Generator().manual_seed(0)
    for leaf in tree_leaves(pool.cache):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    snap = pool.read(1)
    before = tree_map(torch.clone, snap)
    pool.insert(1, pool.single_cache_zeros())
    assert all(float(t.abs().sum()) == 0.0
               for t in tree_leaves(pool.read(1)))
    pool.insert(0, snap)
    for a, b in zip(tree_leaves(before), tree_leaves(pool.read(0))):
        assert torch.equal(a, b)
    assert pool.nbytes == jx.SlotKVPool(jcfg, 2, 64).nbytes
    assert tree_bytes(snap) * 2 == pool.nbytes


# --------------------------------------------------------------------------- #
# media (tests/test_mllm_serving.py:148 and :261) on qwen3-vl-toy
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def vweights(jx):
    return _bridge(jx, "qwen3-vl-toy", reduce=False)


def _img(seed, side=16):
    return np.random.default_rng(seed).integers(0, 256, (side, side, 3),
                                                dtype=np.uint8)


def _media_scenario(vweights, *, policy="edf", preemption=True,
                    with_jax=True, **kw):
    p = Pair(vweights, with_jax, max_batch=1, cache_len=256,
             vision_work_iters=1, sched_policy=policy, preemption=preemption,
             **kw)
    batch = p.req("long multimodal batch request", images=[_img(31)],
                  sampling={"max_tokens": 24})
    p.add(batch)
    p.step(4)
    urgent = p.req(URGENT, sampling={"max_tokens": 6}, deadline_ms=1.0)
    p.add(urgent)
    p.run()
    if with_jax:
        _same(*batch)
        _same(*urgent)
        assert p.te.content_cache_stats() == p.je.content_cache_stats()
        assert p.te._img_encoder.calls == p.je._img_encoder.calls
        assert (batch[1].vision_cache_hits, batch[1].vision_cache_misses) \
            == (batch[0].vision_cache_hits, batch[0].vision_cache_misses)
    return p, batch[1], urgent[1]


@pytest.mark.parametrize("layout", ["dense", "paged-fp"])
def test_media_preemption_resumes_without_reencoding(vweights, layout):
    """The evicted image request resumes from its snapshot (its ctx rows
    and cross KV come back with it): one encoder call in all, and tokens
    equal to the reference's and to the port's FIFO run."""
    p, tb, tu = _media_scenario(vweights, **LAYOUTS[layout])
    assert p.te.scheduler.stats.preemptions >= 1
    assert p.te.scheduler.stats.resumed >= 1
    assert p.te._img_encoder.calls == 1
    assert tu.finish_time < tb.finish_time
    _, fb, fu = _media_scenario(vweights, policy="fifo", preemption=False,
                                with_jax=False, **LAYOUTS[layout])
    assert (tb.output_tokens, tu.output_tokens) == \
        (fb.output_tokens, fu.output_tokens)


@pytest.mark.parametrize("content_cache", [True, False],
                         ids=["content-cache", "no-content-cache"])
def test_media_lost_snapshot_re_encodes_synchronously(vweights,
                                                      content_cache):
    """The snapshot lost to the prefix cache's LRU: the re-prefill resolves
    the image synchronously — an embedding hit with the content cache on,
    a second encoder call with it off — counted as the reference counts."""
    p, tb, _ = _media_scenario(vweights, cache_max_bytes=1,
                               enable_content_cache=content_cache,
                               content_cache_bytes=64 * 1024 * 1024)
    assert p.te.scheduler.stats.resumed == 0
    assert p.te.scheduler.stats.preemptions >= 1
    assert p.te._img_encoder.calls == (1 if content_cache else 2)


def test_paged_xkv_leases_pages_and_pressure_evicts_them(vweights):
    p = Pair(vweights, max_batch=2, cache_len=128, vision_work_iters=1,
             kv_layout="paged")
    r = p.req("paged media", images=[_img(51)], sampling={"max_tokens": 4})
    p.add(r)
    p.run()
    _same(*r)
    leased = p.te.media_stats.xkv_lease_pages
    assert leased > 0 and leased == p.je.media_stats.xkv_lease_pages
    assert p.te.pool.page_occupancy()["reclaimable"] >= leased
    assert p.te.content_cache.evict_cross_kv_lru()
    assert p.je.content_cache.evict_cross_kv_lru()
    assert p.te.media_stats.xkv_lease_pages == 0
    p.check_state()
    r2 = p.req("paged media again", images=[_img(51)],
               sampling={"max_tokens": 4})
    p.add(r2)
    p.run()
    _same(*r2)
    assert p.te.content_cache_stats() == p.je.content_cache_stats()
    assert p.te.media_stats.xkv_lease_pages > 0


# --------------------------------------------------------------------------- #
# on the card: snapshot restore over the decode kernel, adopt over paged
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_scenario(cfg, params, *, policy, preemption, **kw):
    """The reference's scenario on the card; returns the engine, both
    requests, and the batch request's pages at eviction and at resume."""
    eng = InferenceEngine(cfg, params, device="cuda", max_batch=1,
                          cache_len=256, sched_policy=policy,
                          preemption=preemption, **kw)
    batch = Request(prompt_tokens=TOK.encode(BATCH),
                    sampling=SamplingParams(max_tokens=24))
    eng.add_request(batch)
    for _ in range(4):
        eng.step()
    urgent = Request(prompt_tokens=TOK.encode(URGENT),
                     sampling=SamplingParams(max_tokens=6), deadline_ms=1.0)
    eng.add_request(urgent)
    pages, stats = {}, eng.scheduler.stats
    while eng.scheduler.has_work:
        held = (list(eng.pool.slot_pages(0)) if eng._paged else None)
        counts = (stats.preemptions, stats.resumed)
        eng.step()
        if stats.preemptions > counts[0]:
            pages.setdefault("evicted", held)
        if stats.resumed > counts[1]:
            pages.setdefault("resumed", list(eng.pool.slot_pages(0))
                             if eng._paged else None)
    return eng, batch, urgent, pages


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged-fp", "paged-int8"])
def test_card_preemption_resume_through_the_kernels(cuda, layout):
    """Float32 reduced qwen2 on the card: the evictee resumes from its
    snapshot — restored into the dense ring for the decode kernel, or its
    pages adopted for the paged kernel — with tokens identical to the FIFO
    run; the layout's decode kernel runs and the other never."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_attention as pag
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = InferenceEngine(cfg, device="cuda", max_batch=1,
                             cache_len=16).params
    kw = LAYOUTS[layout]
    fifo, fb, fu, _ = _card_scenario(cfg, params, policy="fifo",
                                     preemption=False, **kw)
    dec.decode_attention_cuda.launches = 0
    pag.paged_attention_cuda.launches = 0
    eng, tb, tu, evicted = _card_scenario(cfg, params, policy="edf",
                                          preemption=True, **kw)
    assert eng.scheduler.stats.preemptions >= 1
    assert eng.scheduler.stats.resumed >= 1
    assert tu.finish_time < tb.finish_time
    assert (tb.output_tokens, tu.output_tokens) == \
        (fb.output_tokens, fu.output_tokens)
    used, unused = ((pag.paged_attention_cuda, dec.decode_attention_cuda)
                    if eng._paged else
                    (dec.decode_attention_cuda, pag.paged_attention_cuda))
    assert used.launches > 0 and unused.launches == 0
    if eng._paged:
        assert eng.pool.stats.full_copies == 0
        assert evicted["resumed"][:len(evicted["evicted"])] == \
            evicted["evicted"]
        assert eng.pool.page_occupancy()["pinned"] == 0
