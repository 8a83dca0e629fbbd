"""Slot preemption of the port against the JAX package's engine on the CPU,
given the same weights (bridged from one JAX init, float32): greedy
tokens, preemption and resume counts, page ids, refcounts and
:class:`PageStats` step by step and prefix-cache counters, for the
scenarios of ``tests/test_sched_policy.py`` (bit-identical to FIFO, the
engine-side snapshot, resume after the snapshot is LRU-evicted, FIFO never
preempts, no preemption of ring-wrapped slots) and ``tests/test_paged_kv.py``
(paged resume with the prefix cache on and off on fp and int8 pages).
Seeded sampling replays across a preemption, token for token with the
JAX engine (both draw from threefry streams).  Both engines take the
same arguments, speculative wave filling off.  The page-pressure ladder,
the pools' snapshot primitives, media and the ``gpu`` test are in
``tests/test_torch_preemption_ladder.py``, which imports this harness.
The JAX package is imported inside the CPU tests only (the ``jx``
fixture), so the ladder file's ``gpu`` test runs where JAX is not
installed.
"""
import dataclasses
import logging
import types

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import FinishReason, Request, SamplingParams
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.tokenizer import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401

TOK = ByteTokenizer()
BATCH = "long-running batch request " * 2
URGENT = "urgent interactive!"
PAGED = dict(kv_layout="paged", kv_page_size=16)
LAYOUTS = {"dense": {}, "paged-fp": PAGED,
           "paged-int8": dict(PAGED, kv_dtype="int8")}


@pytest.fixture(scope="module", autouse=True)
def quiet_ladder():
    """The ladder logs each preemption and failure as a warning."""
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (CPU tests only)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.core.engine import InferenceEngine as JaxEngine
    from repro.core.kv_cache import SlotKVPool as JaxSlotPool
    from repro.core.paged_kv import PagedKVPool as JaxPagedPool
    from repro.core.request import Request as JaxRequest
    from repro.core.request import SamplingParams as JaxSampling
    from repro.models import build_model
    return types.SimpleNamespace(
        jax=jax, get_config=jax_get_config, Engine=JaxEngine,
        SlotKVPool=JaxSlotPool, PagedKVPool=JaxPagedPool,
        Request=JaxRequest, SamplingParams=JaxSampling,
        build_model=build_model)


def _bridge(jx, name, reduce=True):
    """(JAX config, port config, JAX params, port params, jx) in float32,
    the port's weights bridged from the JAX init."""
    jcfg, tcfg = jx.get_config(name), get_config(name)
    if reduce:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    jp = jx.build_model(jcfg).init(jx.jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(
        jx.jax.tree.map(np.asarray, jp), tcfg, "cpu"), jx


@pytest.fixture(scope="module")
def weights(jx):
    return _bridge(jx, "qwen2-0.5b")


class Pair:
    """The JAX engine and the port's with the same arguments; ``req``
    makes the same request for both.  ``with_jax=False``: the port's engine
    alone (a reference run of the port itself), requests ``(None, req)``."""

    def __init__(self, weights, with_jax=True, **kw):
        jcfg, tcfg, jp, tp, self.jx = weights
        kw["speculative_fill"] = False
        self.je = (self.jx.Engine(jcfg, jp, **kw) if with_jax else None)
        self.te = InferenceEngine(tcfg, tp, device="cpu", **kw)

    def req(self, text=None, tokens=None, **kw):
        tokens = TOK.encode(text) if tokens is None else tokens
        sampling = kw.pop("sampling", {})
        return (self.jx.Request(prompt_tokens=list(tokens),
                                sampling=self.jx.SamplingParams(**sampling),
                                **kw) if self.je is not None else None,
                Request(prompt_tokens=list(tokens),
                        sampling=SamplingParams(**sampling), **kw))

    def add(self, pair):
        if self.je is not None:
            self.je.add_request(pair[0])
        self.te.add_request(pair[1])

    def step(self, n=1):
        for _ in range(n):
            self.te.step()
            if self.je is not None:
                self.je.step()
                self.check_state()

    def has_work(self):
        return self.te.scheduler.has_work or (
            self.je is not None and self.je.scheduler.has_work)

    def run(self):
        while self.has_work():
            self.step()

    def check_state(self):
        """The per-step bookkeeping the two engines must share."""
        js, ts = self.je.scheduler.stats, self.te.scheduler.stats
        assert (ts.preemptions, ts.resumed, ts.failed) == \
            (js.preemptions, js.resumed, js.failed)
        assert self.te._live_slots == self.je._live_slots
        assert len(self.te._evicted) == len(self.je._evicted)
        if self.te._paged:
            jp, tp = self.je.pool, self.te.pool
            assert tp._slot_pages == jp._slot_pages
            assert tp.allocator._ref == jp.allocator._ref
            assert tp.allocator._free == jp.allocator._free
            assert vars(tp.stats) == vars(jp.stats)
            assert np.array_equal(tp._pt_host, jp._pt_host)
            # the device table mirrors the host's lazily: rows of live
            # slots are what a decode block reads
            live = sorted(self.te._live_slots)
            assert np.array_equal(
                tp.cache["page_table"].numpy()[live],
                np.asarray(jp.cache["page_table"])[live])
        if self.te.prefix_cache is not None:
            assert vars(self.te.prefix_cache.stats) == \
                vars(self.je.prefix_cache.stats)


def _same(jr, tr):
    assert tr.output_tokens == jr.output_tokens
    assert tr.finish_reason.value == jr.finish_reason.value
    assert tr.preempt_count == jr.preempt_count


def _preempt_scenario(weights, *, policy="edf", preemption=True,
                      prefix_cache=True, cache_max_bytes=512 * 1024 * 1024,
                      batch_sampling=None, with_jax=True, **kw):
    """One long batch request decodes alone on one slot; an urgent
    deadline request arrives after 4 steps (the reference's scenario)."""
    p = Pair(weights, with_jax, max_batch=1, cache_len=256,
             sched_policy=policy, preemption=preemption,
             enable_prefix_cache=prefix_cache,
             cache_max_bytes=cache_max_bytes, **kw)
    batch = p.req(BATCH, sampling=batch_sampling or {"max_tokens": 24})
    p.add(batch)
    p.step(4)
    urgent = p.req(URGENT, sampling={"max_tokens": 6}, deadline_ms=1.0)
    p.add(urgent)
    # the batch request's pages when it is evicted and when it resumes
    stats, pool = p.te.scheduler.stats, p.te.pool
    p.pages = {}
    while p.has_work():
        held = {r.request_id: list(pool.slot_pages(s))
                for s, r in p.te.scheduler.active.items()} \
            if p.te._paged else {}
        counts = (stats.preemptions, stats.resumed)
        p.step()
        if stats.preemptions > counts[0]:
            p.pages.setdefault("evicted", held.get(batch[1].request_id))
        if stats.resumed > counts[1] and p.te._paged:
            slot = next(s for s, r in p.te.scheduler.active.items()
                        if r is batch[1])
            p.pages.setdefault("resumed", list(pool.slot_pages(slot)))
    return p, batch, urgent


# --------------------------------------------------------------------------- #
# tests/test_sched_policy.py and tests/test_paged_kv.py:270
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fifo_runs(weights):
    """The port's FIFO run of the scenario (no preemption), by layout and
    prefix cache, made once and shared by the cases that compare with it:
    (pair, batch request pair, urgent request pair)."""
    runs = {}

    def get(layout, prefix_cache=True):
        if (layout, prefix_cache) not in runs:
            runs[layout, prefix_cache] = _preempt_scenario(
                weights, policy="fifo", preemption=False,
                prefix_cache=prefix_cache, with_jax=False, **LAYOUTS[layout])
        return runs[layout, prefix_cache]
    return get


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["cache", "nocache"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_preemption_matches_reference_and_fifo(weights, fifo_runs, layout,
                                               prefix_cache):
    """The urgent request evicts the batch one, which resumes from its
    snapshot — a copy (dense) or its pages by reference (paged), published
    in the prefix cache or held engine-side: both engines step for step the
    same, and the batch request's tokens equal the port's own FIFO run."""
    p, (jb, tb), (ju, tu) = _preempt_scenario(
        weights, prefix_cache=prefix_cache, **LAYOUTS[layout])
    _same(jb, tb)
    _same(ju, tu)
    stats = p.te.scheduler.stats
    assert stats.preemptions >= 1 and stats.resumed >= 1
    assert tu.finish_time < tb.finish_time
    ref, (_, fb), (_, fu) = fifo_runs(layout, prefix_cache)
    assert ref.te.scheduler.stats.preemptions == 0
    assert tb.output_tokens == fb.output_tokens
    assert tu.output_tokens == fu.output_tokens
    if layout != "dense":
        # the resumed slot maps the evicted page ids (a new tail page at
        # most), with no copy
        evicted = p.pages["evicted"]
        assert evicted and p.pages["resumed"][:len(evicted)] == evicted
        occ = p.te.pool.page_occupancy()
        assert occ == p.je.pool.page_occupancy()
        assert occ["pinned"] == 0
        assert occ["free"] + occ["reclaimable"] == occ["total"]
        assert p.te.pool.stats.full_copies == 0


@pytest.mark.parametrize("layout", ["dense", "paged-fp"])
def test_resume_after_snapshot_lru_eviction(weights, fifo_runs, layout):
    """A snapshot squeezed out of the prefix cache's byte budget: the
    batch request re-prefills its prompt + history as one sequence."""
    p, (jb, tb), (ju, tu) = _preempt_scenario(weights, cache_max_bytes=1,
                                              **LAYOUTS[layout])
    _same(jb, tb)
    _same(ju, tu)
    assert p.te.scheduler.stats.preemptions >= 1
    assert p.te.scheduler.stats.resumed == 0
    assert tb.num_generated == 24 and tu.num_generated == 6
    _, (_, fb), _ = fifo_runs(layout)
    assert tb.output_tokens == fb.output_tokens


def test_engine_side_snapshots_bounded_by_pool_size(weights):
    """Without a prefix cache the engine keeps at most ``max_batch``
    snapshots; the oldest evictee falls back to re-prefill."""
    p = Pair(weights, max_batch=1, cache_len=256, sched_policy="edf",
             preemption=True, enable_prefix_cache=False)
    a = p.req("batch request with no deadline " * 2,
              sampling={"max_tokens": 20})
    p.add(a)
    p.step(3)
    b = p.req("soonish deadline", sampling={"max_tokens": 12},
              deadline_ms=30_000.0)
    p.add(b)
    p.step()
    c = p.req("urgent now", sampling={"max_tokens": 4}, deadline_ms=1.0)
    p.add(c)
    p.step(3)
    assert p.te.scheduler.stats.preemptions == 2
    held = [m for m in p.te._evicted.values() if m["cache"] is not None]
    assert len(held) == 1 == p.te.pool.max_batch
    p.run()
    for pair in (a, b, c):
        _same(*pair)
    assert p.te.scheduler.stats.resumed == 1


@pytest.mark.parametrize("layout", ["dense", "paged-fp"])
def test_seeded_sampling_replays_across_preemption(weights, layout):
    """A stochastic seeded request evicted mid-decode resumes its exact
    stream (the draw depends on the base key and position only): the same
    tokens as the JAX engine through the preemption, and as a FIFO run."""
    samp = {"max_tokens": 24, "temperature": 0.9, "top_p": 0.9, "seed": 1234}
    p, (jb, tb), (ju, tu) = _preempt_scenario(weights, batch_sampling=samp,
                                              **LAYOUTS[layout])
    _same(jb, tb)
    _same(ju, tu)
    assert p.te.scheduler.stats.preemptions >= 1
    assert p.te.scheduler.stats.resumed >= 1
    _, (_, fb), (_, fu) = _preempt_scenario(
        weights, policy="fifo", preemption=False, batch_sampling=samp,
        with_jax=False, **LAYOUTS[layout])
    assert len(set(fb.output_tokens)) > 1
    assert tb.output_tokens == fb.output_tokens
    assert tu.output_tokens == fu.output_tokens


def test_fifo_never_preempts_even_when_enabled(weights):
    p, (jb, tb), (ju, tu) = _preempt_scenario(weights, policy="fifo")
    assert p.te.scheduler.stats.preemptions == 0
    _same(jb, tb)
    _same(ju, tu)


def test_no_preemption_of_ring_wrapped_slots(weights):
    p = Pair(weights, max_batch=1, cache_len=64, sched_policy="edf",
             preemption=True)
    hog = p.req("x" * 40, sampling={"max_tokens": 60})
    p.add(hog)
    p.step(6)
    urgent = p.req("now!", sampling={"max_tokens": 2}, deadline_ms=1.0)
    p.add(urgent)
    p.run()
    assert p.te.scheduler.stats.preemptions == 0
    _same(*hog)
    _same(*urgent)
    assert hog[1].finish_time < urgent[1].finish_time


def test_abort_of_a_preempted_request_releases_its_snapshot(weights):
    """Aborting the evictee drops its snapshot: the exact-sequence entry
    leaves the prefix cache and its page refs go back to the arena."""
    p = Pair(weights, max_batch=1, cache_len=256, sched_policy="edf",
             preemption=True, **PAGED)
    batch = p.req(BATCH, sampling={"max_tokens": 24})
    p.add(batch)
    p.step(4)
    urgent = p.req(URGENT, sampling={"max_tokens": 6}, deadline_ms=1.0)
    p.add(urgent)
    p.step()
    assert batch[1].request_id in p.te._evicted
    assert p.te.abort(batch[1].request_id)
    assert p.je.abort(batch[0].request_id)
    p.check_state()
    assert not p.te._evicted
    p.run()
    _same(*urgent)
    assert batch[1].finish_reason is FinishReason.ABORT
    occ = p.te.pool.page_occupancy()
    assert occ == p.je.pool.page_occupancy() and occ["pinned"] == 0


