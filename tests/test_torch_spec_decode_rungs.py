"""Speculative decoding of the port, the second half of
``tests/test_torch_spec_decode.py`` (shared harness imported from it):
spec on = spec off through preemption and resume and through page-arena
exhaustion (a seeded stochastic row included), the draft-model rung
(draft = target: greedy rows emit the JAX engine's spec-off tokens with
acceptance > 0.3; a seeded stochastic stream replays; a vocab mismatch is
refused), the ring and page cell snapshot / restore against the JAX
functions on the same random caches (fp and int8 arenas, a frozen row on
its trash cell), and a ``qwen3-vl-toy`` image request under n-gram (the
cross-attention S > 1 branch) equal to spec off and the JAX engine.

Tolerances: tokens and counters exact, cells bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.kv_cache import gather_ring_cells, restore_ring_cells
from repro_torch.core.paged_kv import gather_page_cells, restore_page_cells
from repro_torch.core.request import Request, SamplingParams
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import tree_leaves, tree_map
from test_torch_spec_decode import (MIX, PAGED, REP, TOK, _mk,  # noqa: F401
                                    _reqs, _tokens, jax_off_tokens, jx,
                                    weights)
from torch_threads import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------- #
# spec on = spec off under preemption and page pressure
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_ngram_identical_under_preemption_and_resume(weights, layout):
    """Spec rounds + preemption: a preempted-and-resumed slot re-enters
    speculation (EWMA reset, drafts from the committed history) and still
    emits the spec-off stream, a seeded stochastic row included."""
    kw = PAGED if layout == "paged" else {}

    def load():
        longs = [Request(prompt_tokens=TOK.encode(REP),
                         sampling=SamplingParams(max_tokens=30))
                 for _ in range(2)]
        longs.append(Request(prompt_tokens=TOK.encode(MIX),
                             sampling=SamplingParams(
                                 max_tokens=30, temperature=0.9, top_p=0.9,
                                 seed=3)))
        vip = Request(prompt_tokens=TOK.encode("urgent"),
                      sampling=SamplingParams(max_tokens=8), priority=5)
        return longs, vip

    outs = []
    for spec in ({}, {"spec_mode": "ngram", "spec_k": 4}):
        eng = _mk(weights, max_batch=2, sched_policy="priority",
                  preemption=True, **kw, **spec)
        longs, vip = load()
        for r in longs:
            eng.add_request(r)
        eng.step()
        eng.add_request(vip)        # evicts a running long request
        while not all(r.is_finished for r in longs + [vip]):
            eng.step()
        assert sum(r.preempt_count for r in longs) > 0
        outs.append(_tokens(longs + [vip]))
        if spec:
            assert eng.speculation_stats()["rounds"] > 0
    assert outs[0] == outs[1]


def test_paged_exhaustion_with_spec_active(weights):
    """Page-arena pressure while speculating: capacity for spec_k + 1 steps
    is ensured per round (preempting if needed), every request completes
    with its spec-off tokens (a seeded stochastic one included), and every
    page returns."""
    def reqs():
        out = [Request(prompt_tokens=TOK.encode(REP),
                       sampling=SamplingParams(max_tokens=40))
               for _ in range(3)]
        out.append(Request(prompt_tokens=TOK.encode(MIX),
                           sampling=SamplingParams(max_tokens=40,
                                                   temperature=0.9, seed=5)))
        return out

    # 14 pages: 12 past the reserved ones, fewer than three live slots
    # grow to, so the ladder preempts (rung 2) and the victims re-prefill
    kw = dict(max_batch=3, kv_num_pages=14, preemption=True, **PAGED)
    ref = _mk(weights, **kw).generate(reqs())
    eng = _mk(weights, spec_mode="ngram", spec_k=4, **kw)
    free0 = eng.pool.allocator.num_free
    done = eng.generate(reqs())
    assert all(r.is_finished for r in done)
    assert _tokens(done) == _tokens(ref)
    assert eng.pool.allocator.num_free == free0
    assert eng.scheduler.stats.preemptions > 0
    assert eng.speculation_stats()["rounds"] > 0


# --------------------------------------------------------------------------- #
# draft-model rung
# --------------------------------------------------------------------------- #
def test_draft_model_oracle_accepts_and_matches_greedy(weights,
                                                       jax_off_tokens):
    """Draft == target (same config and params): greedy rows emit the
    spec-off stream (the JAX engine's tokens) with high acceptance."""
    ref = _mk(weights).generate(_reqs())
    eng = _mk(weights, spec_mode="draft", spec_k=4,
              spec_draft_config=weights[1], spec_draft_params=weights[3])
    got = eng.generate(_reqs())
    for a, b in zip(ref[:2], got[:2]):          # the two greedy rows
        assert a.output_tokens == b.output_tokens
    assert _tokens(got[:2]) == jax_off_tokens[:2]
    stats = eng.speculation_stats()
    assert stats["acceptance_rate"] > 0.3
    assert stats["draft_pool_bytes"] > 0
    assert eng._draft_source.prefills == 3


def test_draft_model_stochastic_seeded_replay(weights):
    """The rejection-sampled stream is not the spec-off stream, but it is a
    full completion and replays token for token across engines."""
    def run():
        eng = _mk(weights, spec_mode="draft", spec_k=4,
                  spec_draft_config="qwen3-0.6b-toy")
        r = Request(prompt_tokens=TOK.encode(MIX),
                    sampling=SamplingParams(max_tokens=20, temperature=0.9,
                                            top_p=0.9, seed=42))
        eng.generate([r])
        assert r.is_finished and len(r.output_tokens) == 20
        assert eng.speculation_stats()["rounds"] > 0
        return r.output_tokens
    assert run() == run()


def test_draft_model_requires_matching_vocab(weights):
    bad = dataclasses.replace(weights[1], vocab_size=weights[1].vocab_size * 2)
    with pytest.raises(ValueError, match="vocab"):
        _mk(weights, spec_mode="draft", spec_draft_config=bad)
    with pytest.raises(ValueError, match="spec_draft_config"):
        _mk(weights, spec_mode="draft")


# --------------------------------------------------------------------------- #
# cell snapshot / rollback against the JAX functions
# --------------------------------------------------------------------------- #
def _random_tree(jx, tree, rng):
    """A numpy copy of a JAX cache tree with random leaves (int8 leaves
    random bytes, scale leaves positive)."""
    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.integers(-128, 128, a.shape).astype(np.int8)
        if a.dtype.kind == "i":
            return a.copy()
        return (rng.standard_normal(a.shape) + 2).astype(a.dtype)
    return jx.jax.tree.map(fill, tree)


def _to_jax(jx, tree):
    return jx.jax.tree.map(jx.jax.numpy.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _same_trees(jtree, ttree):
    jl = [np.asarray(a) for a in tree_leaves(jtree)]
    tl = [t.numpy() for t in tree_leaves(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b-toy", "deepseek-moe-16b"])
def test_ring_cell_snapshot_and_restore_match_reference(jx, arch):
    """Prefix and stacked block leaves: the port's gather and in-place
    restore equal the JAX functions on the same random cache."""
    jcfg, tcfg = jx.get_config(arch), get_config(arch)
    if arch != "qwen3-0.6b-toy":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    rng = np.random.default_rng(0)
    b, s, sc = 3, 5, 32
    before = _random_tree(jx, jx.jax.tree.map(np.asarray, jx.kv.init_cache(
        jcfg, b, sc)), rng)
    after = _random_tree(jx, before, rng)      # the forward's writes
    slots = (rng.integers(0, sc, (b, 1)) + np.arange(s)) % sc
    keep = rng.random((b, s)) < 0.5
    jsnap = jx.kv.gather_ring_cells(_to_jax(jx, before), slots)
    want = jx.kv.restore_ring_cells(_to_jax(jx, after), jsnap, slots, keep)
    tsnap = gather_ring_cells(_to_torch(before), torch.from_numpy(slots))
    _same_trees(jsnap, tsnap)
    got = _to_torch(after)
    restore_ring_cells(got, tsnap, torch.from_numpy(slots),
                       torch.from_numpy(keep))
    _same_trees(want, got)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_page_cell_snapshot_and_restore_match_reference(jx, weights,
                                                        kv_dtype):
    """Every arena leaf (scales on int8 pages): the port's gather and
    in-place restore equal the JAX functions, with frozen rows redirected
    to their trash cell (repeated indices carrying one snapshot value)."""
    jcfg = weights[0]
    b, s, ps = 3, 5, 16
    jpool = jx.paged.PagedKVPool(jcfg, b, 64, page_size=ps, kv_dtype=kv_dtype)
    rng = np.random.default_rng(1)
    arena = {k: v for k, v in jx.jax.tree.map(np.asarray,
                                              jpool.cache).items()
             if k != "page_table"}
    before = _random_tree(jx, arena, rng)
    after = _random_tree(jx, before, rng)
    pages = rng.integers(jpool.reserved, jpool.num_pages, (b, s))
    offs = rng.integers(0, ps, (b, s))
    pages[1], offs[1] = 1 // ps, 1 % ps         # a frozen row: trash cell
    keep = rng.random((b, s)) < 0.5
    keep[1] = False
    jsnap = jx.paged.gather_page_cells(_to_jax(jx, before), pages, offs)
    want = jx.paged.restore_page_cells(_to_jax(jx, after), jsnap, pages,
                                       offs, keep)
    tsnap = gather_page_cells(_to_torch(before), torch.from_numpy(pages),
                              torch.from_numpy(offs))
    _same_trees(jsnap, tsnap)
    got = _to_torch(after)
    restore_page_cells(got, tsnap, torch.from_numpy(pages),
                       torch.from_numpy(offs), torch.from_numpy(keep))
    _same_trees(want, got)


# --------------------------------------------------------------------------- #
# vision: the cross-attention S > 1 branch
# --------------------------------------------------------------------------- #
def test_vision_image_request_under_ngram_matches_reference(jx):
    """A ``qwen3-vl-toy`` image request (gates opened to 0.5) with a
    repetitive prompt: n-gram rounds run the cross-attention S > 1 branch,
    and the tokens equal spec off and the JAX engine's spec-on run."""
    jcfg, tcfg = jx.get_config("qwen3-vl-toy"), get_config("qwen3-vl-toy")
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    tree = jx.jax.tree.map(np.asarray,
                           jx.build_model(jcfg).init(
                               jx.jax.random.PRNGKey(0)))
    for layer in list(tree["prefix_layers"]) + list(tree["block"].values()):
        if "xgate_ffn" in layer:
            layer["xgate_ffn"] = np.full_like(layer["xgate_ffn"], 0.5)
            layer["cross"]["xgate_attn"] = np.full_like(
                layer["cross"]["xgate_attn"], 0.5)
    jp = jx.jax.tree.map(jx.jax.numpy.asarray, tree)
    tp = params_from_jax(tree, tcfg, "cpu")
    image = np.random.default_rng(3).integers(0, 256, (16, 16, 3),
                                              dtype=np.uint8)
    kw = dict(max_batch=2, cache_len=128, vision_work_iters=1,
              enable_prefix_cache=False)
    spec = dict(spec_mode="ngram", spec_k=4)

    def reqs(R, S):
        return [R(prompt_tokens=TOK.encode(REP), images=[image],
                  sampling=S(max_tokens=16)),
                R(prompt_tokens=TOK.encode(REP), sampling=S(max_tokens=12))]

    je = jx.Engine(jcfg, jp, speculative_fill=False, **kw, **spec)
    jr = je.generate(reqs(jx.Request, jx.SamplingParams))
    te = InferenceEngine(tcfg, tp, device="cpu", speculative_fill=False,
                         **kw, **spec)
    tr = te.generate(reqs(Request, SamplingParams))
    off = InferenceEngine(tcfg, tp, device="cpu", speculative_fill=False,
                          **kw).generate(
        reqs(Request, SamplingParams))
    assert _tokens(tr) == _tokens(jr) == _tokens(off)
    assert te.speculation_stats() == je.speculation_stats()
    assert te.speculation_stats()["rounds"] > 0
