"""The port's engine on the recurrent families against the JAX package's
engine on the CPU, given the same weights (bridged from one JAX init,
float32): ``mamba2-780m`` and ``jamba-1.5-large-398b``, both reduced (2
Mamba layers; one group of 8 layers with one attention layer and 4 MoE
blocks).

Greedy tokens must be identical, and so must :class:`PageStats`, page
refcounts, the prefix-cache counters and the preemption counters: on the
dense ring and on pages, with ``prefill_chunk`` 32 and 0, the prefix cache
on and off.  The traffic sends one prompt twice in a row with the prefix
cache on, which is where the reference's kept quirk shows: a prefix-cache
value carries ``conv``/``state`` at the value's own length, a hit resumes
at a shorter block boundary, and on jamba the second request's tokens
differ from the first's (``ROADMAP.md`` §3).  Preemption, a lost
snapshot, handoff and the speculation gate are in
``tests/test_torch_ssm_preemption.py``, which imports this harness.  Both
engines take the same arguments, speculative wave filling off.
"""
import logging

import numpy as np
import pytest

from test_torch_preemption import (LAYOUTS, Pair, _bridge,  # noqa: F401
                                   _same, jx)
from torch_threads import one_torch_thread  # noqa: F401

MODELS = ("mamba2-780m", "jamba-1.5-large-398b")
QUIRK = "The quick brown fox jumps over the lazy dog near the river bank"
# (layout, prefill_chunk, prefix cache)
CASES = {"dense-chunk32-cache": ("dense", 32, True),
         "paged-chunk32-nocache": ("paged-fp", 32, False),
         "paged-chunk0-cache": ("paged-fp", 0, True)}
# jamba's JAX engine compiles for ~15 s a case: two of the three cases
RUNS = [(n, c) for n in MODELS for c in CASES
        if n == "mamba2-780m" or c != "paged-chunk0-cache"]


@pytest.fixture(scope="module", autouse=True)
def quiet_ladder():
    """The engines log each preemption as a warning."""
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def bridged(jx):
    made = {}

    def get(name):
        if name not in made:
            made[name] = _bridge(jx, name)
        return made[name]
    return get


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 256, size=n)]
            for n in (5, 40, 70, 17, 3)]


@pytest.mark.parametrize("name,case", RUNS)
def test_greedy_tokens_and_counters_match_reference(bridged, name, case):
    """7 requests on 2 slots (one prompt twice, one a prefix of another),
    checked step by step; then one prompt sent twice in a row."""
    layout, chunk, cache = CASES[case]
    p = Pair(bridged(name), max_batch=2, cache_len=128, prefill_chunk=chunk,
             enable_prefix_cache=cache, **LAYOUTS[layout])
    prompts = _prompts()
    pairs = [p.req(tokens=t, sampling={"max_tokens": 8})
             for t in prompts + [prompts[1], prompts[2][:50]]]
    for pair in pairs:
        p.add(pair)
    p.run()
    for pair in pairs:
        _same(*pair)
    repeat = []
    for _ in range(2):
        pair = p.req(QUIRK[:61], sampling={"max_tokens": 10})
        p.add(pair)
        p.run()
        _same(*pair)
        repeat.append(pair[1])
    if cache:
        assert vars(p.te.prefix_cache.stats) == vars(p.je.prefix_cache.stats)
        assert p.te.prefix_cache.stats.hits >= 2
        assert repeat[1].cached_prefix_len == 48
    if layout != "dense":
        assert vars(p.te.pool.stats) == vars(p.je.pool.stats)
        assert p.te.pool.allocator._ref == p.je.pool.allocator._ref
        assert p.te.pool.page_bytes == p.je.pool.page_bytes
        if name == "mamba2-780m":      # no attention layer: no arena leaf
            assert p.te.pool.page_bytes == 0
    if case == "dense-chunk32-cache" and name.startswith("jamba"):
        # the kept quirk: the hit at 48 tokens resumes from the state the
        # retired request published after its prompt + generated tokens
        assert repeat[1].output_tokens[0] == repeat[0].output_tokens[0]
        assert repeat[1].output_tokens != repeat[0].output_tokens
    elif not cache:
        assert repeat[1].output_tokens == repeat[0].output_tokens


@pytest.mark.parametrize("layout", ["dense", "paged-fp"])
def test_prefix_budget_evictions_match_reference(bridged, layout):
    """A prefix-cache entry of a Mamba model carries every layer's float32
    ``state``, so a byte budget holds few (``mamba2-780m`` at published
    widths: ~7 in 512 MiB).  With a budget of about two entries, the 7
    requests and one prompt sent twice evict: the hits, insertions and
    evictions (step by step), the hit lengths and the tokens equal the JAX
    engine's on each layout."""
    kw = dict(max_batch=2, cache_len=128, prefill_chunk=32,
              **LAYOUTS[layout])
    alone = Pair(bridged("mamba2-780m"), with_jax=False, **kw)
    prompts = _prompts()
    alone.add(alone.req(tokens=prompts[2], sampling={"max_tokens": 8}))
    alone.run()
    lru = alone.te.prefix_cache._lru
    entry = lru.nbytes // len(lru)
    p = Pair(bridged("mamba2-780m"), cache_max_bytes=5 * entry // 2, **kw)
    pairs = [p.req(tokens=t, sampling={"max_tokens": 8})
             for t in prompts + [prompts[1], prompts[2][:50]]]
    for pair in pairs:
        p.add(pair)
    p.run()
    for _ in range(2):                  # the second one hits the first
        pairs.append(p.req(QUIRK[:61], sampling={"max_tokens": 10}))
        p.add(pairs[-1])
        p.run()
    for jr, tr in pairs:
        _same(jr, tr)
        assert tr.cached_prefix_len == jr.cached_prefix_len
    stats = p.te.prefix_cache.stats
    assert vars(stats) == vars(p.je.prefix_cache.stats)
    assert stats.evictions > 0 and stats.hits > 0
