"""Speculative decoding of the port against the JAX package on the CPU,
given the same weights (``qwen3-0.6b-toy``, bridged from one JAX init):
the tests of ``tests/test_spec_decode.py`` ported, plus parity with the
JAX engine — greedy n-gram tokens equal the JAX engine's spec-on and
spec-off tokens (K 1 and 8, solo and batched), the ``speculation_stats``
counters and, on the paged layout, page ids, refcounts, the free list and
``PageStats`` equal the JAX engine's step by step.  The rest — preemption
and page pressure under spec, the draft-model rung, the cell snapshot /
restore against the JAX functions and the vision request — is in
``tests/test_torch_spec_decode_rungs.py``, which imports this harness.

Tolerances: tokens and counters exact, logprobs 1e-5 (float32).  Seeded
stochastic rows are held port against port (the port's random stream is a
counter hash, not threefry), and the hypothesis property holds the port's
verify round to the port's host ``verify_reference``.  The ``gpu`` test
runs speculation on the card through the decode and paged kernels and skips
without one.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.kv_cache import (SlotKVPool, admit_decode_state,
                                       init_decode_state)
from repro_torch.core.request import Request, SamplingParams
from repro_torch.core.sampling import request_base_key
from repro_torch.core.spec_decode import (NGramProposer, SpecController,
                                          build_spec_verify_fn, stage_drafts,
                                          verify_reference)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import init_cache, tree_map
from repro_torch.serving.tokenizer import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

TOK = ByteTokenizer()
# repetition-heavy prompt: prompt-lookup drafting finds long continuations
REP = "the cat sat on the mat and the cat sat on the mat again and "
MIX = "zq pw lx " + REP
PAGED = dict(kv_layout="paged", kv_page_size=16, enable_content_cache=False)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (CPU tests only)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.core import kv_cache as jkv
    from repro.core import paged_kv as jpaged
    from repro.core.engine import InferenceEngine as JaxEngine
    from repro.core.request import Request as JaxRequest
    from repro.core.request import SamplingParams as JaxSampling
    from repro.models import build_model
    return types.SimpleNamespace(
        jax=jax, get_config=jax_get_config, Engine=JaxEngine, kv=jkv,
        paged=jpaged, Request=JaxRequest, SamplingParams=JaxSampling,
        build_model=build_model)


@pytest.fixture(scope="module")
def weights(jx):
    """(JAX config, port config, JAX params, port params)."""
    jcfg, tcfg = jx.get_config("qwen3-0.6b-toy"), get_config("qwen3-0.6b-toy")
    jp = jx.build_model(jcfg).init(jx.jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jx.jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


@pytest.fixture(scope="module")
def cfg(weights):
    return weights[1]


def _mk(weights, *, max_batch=3, K=8, **kw):
    """The port's engine on the bridged weights (the JAX test's ``_mk``)."""
    return InferenceEngine(weights[1], weights[3], device="cpu",
                           max_batch=max_batch, cache_len=256, seed=0,
                           max_decode_block=K, enable_prefix_cache=False,
                           speculative_fill=False, **kw)


def _mk_jax(jx, weights, *, max_batch=3, K=8, **kw):
    return jx.Engine(weights[0], weights[2], speculative_fill=False,
                     max_batch=max_batch, cache_len=256, seed=0,
                     max_decode_block=K, enable_prefix_cache=False, **kw)


def _reqs(n_tok=24, greedy=False, make=(Request, SamplingParams)):
    """A mixed batch: repetition-heavy greedy, short greedy, and MIX —
    seeded stochastic, or greedy with ``greedy`` — with budgets that retire
    the slots at different rounds."""
    R, S = make
    third = {} if greedy else dict(temperature=0.9, top_p=0.9, seed=42)
    return [R(prompt_tokens=TOK.encode(REP), sampling=S(max_tokens=n_tok)),
            R(prompt_tokens=TOK.encode("short one"),
              sampling=S(max_tokens=n_tok // 2)),
            R(prompt_tokens=TOK.encode(MIX),
              sampling=S(max_tokens=n_tok, **third))]


def _tokens(reqs):
    return [r.output_tokens for r in reqs]


@pytest.fixture(scope="module")
def jax_off_tokens(jx, weights):
    """The JAX engine's spec-off greedy tokens (invariant to K)."""
    make = (jx.Request, jx.SamplingParams)
    return _tokens(_mk_jax(jx, weights).generate(_reqs(greedy=True,
                                                       make=make)))


# --------------------------------------------------------------------------- #
# n-gram proposer (host)
# --------------------------------------------------------------------------- #
def test_ngram_proposer_prompt_lookup():
    p = NGramProposer(max_n=3)
    hist = [5, 6, 7, 9, 5, 6, 7, 9]      # trailing [6,7,9] recurs at 1..3
    assert p.propose(hist + [5], 3) == [6, 7, 9]
    assert p.propose(hist + [5], 2) == [6, 7]
    assert p.propose([1, 2, 3, 4, 5], 4) == []
    # most recent occurrence wins over an earlier different continuation
    assert p.propose([1, 9, 2, 1, 9, 3, 1, 9], 1) == [3]
    assert p.propose([], 4) == [] and p.propose([7], 4) == []


# --------------------------------------------------------------------------- #
# greedy parity with the JAX engine, step by step
# --------------------------------------------------------------------------- #
def _check_pages(te, je):
    tp, jp = te.pool, je.pool
    assert tp._slot_pages == jp._slot_pages
    assert tp.allocator._ref == jp.allocator._ref
    assert tp.allocator._free == jp.allocator._free
    assert vars(tp.stats) == vars(jp.stats)
    assert np.array_equal(tp._pt_host, jp._pt_host)


@pytest.mark.parametrize("layout,K", [("dense", 1), ("dense", 8),
                                      ("paged", 8)])
def test_greedy_ngram_matches_reference_step_by_step(jx, weights,
                                                     jax_off_tokens, layout,
                                                     K):
    """Both engines in lockstep on the greedy batch: the same tokens as
    the JAX engine's spec-on and spec-off runs and the port's own spec-off
    run; ``speculation_stats`` and the scheduler's step counters equal
    after every step; on pages, page ids, refcounts, the free list and
    PageStats too, and every page back on the free list at the end."""
    kw = dict(K=K, **(PAGED if layout == "paged" else {}))
    je = _mk_jax(jx, weights, spec_mode="ngram", spec_k=4, **kw)
    te = _mk(weights, spec_mode="ngram", spec_k=4, **kw)
    free0 = te.pool.allocator.num_free if layout == "paged" else None
    jr = _reqs(greedy=True, make=(jx.Request, jx.SamplingParams))
    tr = _reqs(greedy=True)
    for a, b in zip(jr, tr):
        je.add_request(a)
        te.add_request(b)
    while je.scheduler.has_work or te.scheduler.has_work:
        je.step()
        te.step()
        assert te.speculation_stats() == je.speculation_stats()
        js, ts = je.scheduler.stats, te.scheduler.stats
        assert (ts.steps, ts.device_steps, ts.tokens_generated) == \
            (js.steps, js.device_steps, js.tokens_generated)
        if layout == "paged":
            _check_pages(te, je)
    off = _mk(weights, **kw).generate(_reqs(greedy=True))
    assert _tokens(tr) == _tokens(jr) == jax_off_tokens == _tokens(off)
    stats = te.speculation_stats()
    assert stats["rounds"] > 0 and stats["tokens_accepted"] > 0
    assert stats["tokens_accepted"] + stats["tokens_rejected"] == \
        stats["tokens_drafted"]
    if layout == "paged":
        assert te.pool.allocator.num_free == free0


@pytest.fixture(scope="module")
def port_runs(weights):
    """The port's runs of the mixed batch by (K, spec on), each made once
    and shared by the cases that repeat it: (finished requests, engine)."""
    runs = {}

    def get(K, spec):
        if (K, spec) not in runs:
            eng = _mk(weights, K=K, **(dict(spec_mode="ngram", spec_k=4)
                                       if spec else {}))
            runs[K, spec] = (eng.generate(_reqs()), eng)
        return runs[K, spec]
    return get


@pytest.mark.parametrize("K", [1, 8])
def test_ngram_token_identical_to_off_across_block_sizes(port_runs, K):
    """The mixed batch, its seeded stochastic row included: spec on equals
    spec off inside the port."""
    ref = _tokens(port_runs(K, False)[0])
    got, eng = port_runs(K, True)
    assert _tokens(got) == ref
    assert all(r.finish_reason is not None for r in got)
    stats = eng.speculation_stats()
    assert stats["rounds"] > 0 and stats["tokens_drafted"] > 0
    assert stats["tokens_accepted"] + stats["tokens_rejected"] \
        == stats["tokens_drafted"]


def test_ngram_identical_to_off_solo_vs_batched(weights, port_runs,
                                                jax_off_tokens):
    """Per-slot streams do not depend on the batch with spec on (staged
    neighbours, seq_valid masking, per-slot rollback); the greedy rows are
    the JAX engine's tokens."""
    solo = []
    for r in _reqs():
        _mk(weights, max_batch=1, spec_mode="ngram", spec_k=4).generate([r])
        solo.append(r.output_tokens)
    batched = port_runs(8, True)[0]
    assert _tokens(batched) == solo
    assert solo[:2] == jax_off_tokens[:2]


def test_seeded_stochastic_ngram_replays_spec_off_stream(weights):
    """The match rule samples targets from the plain per-token stream, so a
    seeded stochastic ngram request is the spec-off stream too."""
    def req():
        return Request(prompt_tokens=TOK.encode(MIX),
                       sampling=SamplingParams(max_tokens=20, temperature=0.9,
                                               top_p=0.9, seed=7))
    r_off, r_on = req(), req()
    _mk(weights).generate([r_off])
    _mk(weights, spec_mode="ngram", spec_k=4).generate([r_on])
    assert r_on.output_tokens == r_off.output_tokens
    assert len(set(r_on.output_tokens)) > 1


# --------------------------------------------------------------------------- #
# K adaptation + stats plumbing
# --------------------------------------------------------------------------- #
def test_controller_probation_and_recovery():
    c = SpecController(alpha=0.5, probation_rounds=4)
    c.on_admit(0)
    assert c.tick() == 1.0
    for _ in range(8):
        c.observe(0, 4, 0)          # everything rejected
    assert c.round_acceptance() < 0.15
    assert c.tick(low_water=0.15) == 0.0      # probation entered
    for _ in range(4):
        assert c.tick() == 0.0                # cooldown holds
    assert c.tick() == 1.0                    # expiry resets optimistic
    c.release(0)
    assert c.snapshot() == {}


def test_scheduler_gates_spec_under_pressure(weights):
    eng = _mk(weights, max_batch=2, spec_mode="ngram", spec_k=4)
    s = eng.scheduler
    assert s.plan_spec_k(4, 1.0) == 0         # no active slots yet
    for r in _reqs()[:2]:
        eng.add_request(r)
    for _ in range(20):                       # step until prefills commit
        eng.step()
        if len(s.active) == 2 and not s.pending and not s.chunk_queue:
            break
    assert s.plan_spec_k(4, 1.0) == 4
    assert s.plan_spec_k(4, 0.3) == 2         # low acceptance halves K
    assert s.plan_spec_k(4, 0.1) == 0         # below low-water: off
    assert s.plan_spec_k(4, 1.0, reclaim_queued=True) == 0
    eng.add_request(_reqs()[0])               # pending pressure (batch full)
    assert s.plan_spec_k(4, 1.0) == 0


def test_speculation_stats_shape(weights, port_runs):
    s = port_runs(8, True)[1].speculation_stats()
    for k in ("mode", "k", "rounds", "tokens_drafted", "tokens_accepted",
              "tokens_rejected", "tokens_emitted", "acceptance_rate",
              "slot_acceptance_ewma", "draft_pool_bytes"):
        assert k in s
    off = _mk(weights).speculation_stats()
    assert off["mode"] == "off" and off["rounds"] == 0
    with pytest.raises(ValueError, match="spec_mode"):
        _mk(weights, spec_mode="medusa")


def test_logprobs_through_spec_rounds(weights):
    """Per-token logprobs with spec on: the same tokens and logprob values
    (1e-5) as spec off, from the verify forward's per-position logits."""
    def run(**kw):
        r = Request(prompt_tokens=TOK.encode(REP),
                    sampling=SamplingParams(max_tokens=12, logprobs=True,
                                            top_logprobs=2))
        eng = _mk(weights, **kw)
        eng.generate([r])
        return r, eng
    (a, _), (b, eng) = run(), run(spec_mode="ngram", spec_k=4)
    assert eng.speculation_stats()["rounds"] > 0
    assert a.output_tokens == b.output_tokens
    assert len(b.output_logprobs) == len(b.output_tokens)
    for (lp_a, top_a), (lp_b, top_b) in zip(a.output_logprobs,
                                            b.output_logprobs):
        assert lp_a == pytest.approx(lp_b, abs=1e-5)
        assert [t for t, _ in top_a] == [t for t, _ in top_b]


# --------------------------------------------------------------------------- #
# hypothesis property: the verify round == the host reference
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def target(weights):
    """The port's model and params, and the target's own greedy
    continuation of the property prompt (perfect drafts, driving the
    full-acceptance + bonus path)."""
    eng = InferenceEngine(weights[1], weights[3], device="cpu", max_batch=1,
                          cache_len=64, max_decode_block=1,
                          enable_prefix_cache=False)
    r = Request(prompt_tokens=TOK.encode("property test prompt"),
                sampling=SamplingParams(max_tokens=5))
    eng.generate([r])
    return eng.model, eng.params, np.asarray(r.output_tokens[:4], np.int64)


def _seeded_round(cfg, model, params, *, spec_k, drafts, temperature,
                  top_p, top_k, seed, use_q, q_eps):
    """ONE verify round on a hand-built slot: (device-emitted,
    host-reference) tokens."""
    cache_len, B = 64, 2
    prompt = TOK.encode("property test prompt")
    ln = len(prompt)
    pool = SlotKVPool(cfg, B, cache_len, device="cpu")
    bucket = 32
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :ln - 1] = torch.tensor(prompt[:-1])
    row = init_cache(cfg, 1, cache_len, device="cpu")
    ar = torch.arange(bucket)[None]
    model.apply(params, toks, mode="prefill", positions=ar, cache=row,
                seq_valid=ar < ln - 1, logits_mode="last")
    pool.insert(0, row)

    base_key = request_base_key(seed)
    state = init_decode_state(B, 1, spec_k=spec_k, device="cpu")
    admit_decode_state(state, [0], last_token=[prompt[-1]],
                       positions=[ln - 1], temps=[temperature], top_p=[top_p],
                       top_k=[top_k], min_p=[0.0], sample_key=[base_key],
                       budget=[100], active=[True])
    d_host = np.zeros((B, spec_k), np.int64)
    d_host[0] = drafts
    lens = np.zeros((B,), np.int64)
    lens[0] = spec_k
    V = cfg.vocab_size
    q = None
    if use_q:    # draft "quality": an eps-smoothed point mass on the draft
        q_np = np.full((B, spec_k, V), q_eps / V, np.float32)
        for j, d in enumerate(drafts):
            q_np[0, j, d] += 1.0 - q_eps
        q = torch.from_numpy(q_np)

    # host reference: the target one token at a time over [last, d_0 ..]
    ref_cache = tree_map(torch.clone, pool.cache)
    rows = []
    tok_in = [prompt[-1]] + [int(d) for d in drafts]
    act = torch.tensor([True, False])
    for j in range(spec_k + 1):
        out = model.apply(params, torch.tensor([[tok_in[j]], [0]]),
                          mode="decode",
                          positions=torch.tensor([[ln - 1 + j], [0]]),
                          cache=ref_cache, slot_active=act)
        rows.append(out.logits[0, 0].float().numpy())
    host = verify_reference(np.stack(rows), drafts,
                            None if q is None else q[0].numpy(), base_key,
                            ln - 1, temperature, top_p, top_k, 0.0, use_q)

    verify = build_spec_verify_fn(model, use_ctx=False, n_top=1,
                                  paged=False, cache_len=cache_len)
    stage_drafts(state, d_host, lens)
    emit, _, _, _ = verify(params, pool.cache, state, q, spec_k=spec_k,
                           use_q=use_q)
    device = [int(t) for t in emit[:, 0] if t >= 0]
    return device, host


if HAS_HYPOTHESIS:
    @settings(max_examples=8, deadline=None)
    @given(data=st.data())
    def test_verify_round_matches_host_reference(cfg, target, data):
        """Arbitrary (draft quality, k, sampler) mixes: the batched verify
        round emits exactly what the one-token-at-a-time host reference
        does — match rule and rejection-correction rule alike."""
        spec_k = data.draw(st.integers(1, 4), label="k")
        seed = data.draw(st.integers(0, 2**32), label="seed")
        temperature = data.draw(st.sampled_from([0.0, 0.7, 1.3]),
                                label="temp")
        top_p = data.draw(st.sampled_from([1.0, 0.9]), label="top_p")
        top_k = data.draw(st.sampled_from([0, 40]), label="top_k")
        use_q = data.draw(st.booleans(), label="use_q")
        q_eps = data.draw(st.sampled_from([0.05, 0.9]), label="q_eps")
        rng = np.random.default_rng(seed)
        model, params, oracle = target
        quality = data.draw(st.sampled_from(["random", "oracle", "mixed"]),
                            label="draft quality")
        if quality == "random":
            drafts = rng.integers(0, cfg.vocab_size, spec_k)
        elif quality == "oracle":
            drafts = oracle[:spec_k]
        else:                       # good prefix, garbage tail
            drafts = oracle[:spec_k].copy()
            drafts[-1] = rng.integers(0, cfg.vocab_size)
        device, host = _seeded_round(
            cfg, model, params, spec_k=spec_k, drafts=drafts,
            temperature=temperature, top_p=top_p, top_k=top_k, seed=seed,
            use_q=use_q, q_eps=q_eps)
        assert device == host


# --------------------------------------------------------------------------- #
# on the card: verify rounds through the decode and paged kernels
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged-fp", "paged-int8"])
def test_card_ngram_rounds_through_the_kernels(cuda, layout):
    """Float32 reduced qwen2 on the card: n-gram rounds give the spec-off
    tokens (a seeded stochastic row included), and the layout's kernel
    runs ``layers x (block steps + 5 x rounds)`` times, the other never."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_attention as pag
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    kw = {"dense": {}, "paged-fp": dict(PAGED),
          "paged-int8": dict(PAGED, kv_dtype="int8")}[layout]
    params = InferenceEngine(tcfg, device="cuda", max_batch=1,
                             cache_len=16).params

    def run(**spec):
        eng = InferenceEngine(tcfg, params, device="cuda", max_batch=3,
                              cache_len=256, enable_prefix_cache=False,
                              **kw, **spec)
        return eng, eng.generate(_reqs())

    _, ref = run()
    dec.decode_attention_cuda.launches = 0
    pag.paged_attention_cuda.launches = 0
    eng, got = run(spec_mode="ngram", spec_k=4)
    assert _tokens(got) == _tokens(ref)
    stats, sched = eng.speculation_stats(), eng.scheduler.stats
    assert stats["rounds"] > 0
    used, unused = ((pag.paged_attention_cuda, dec.decode_attention_cuda)
                    if eng._paged else
                    (dec.decode_attention_cuda, pag.paged_attention_cuda))
    blocks = sched.device_steps - stats["rounds"]
    assert used.launches == tcfg.num_layers * (blocks + 5 * stats["rounds"])
    assert unused.launches == 0
    if eng._paged:
        assert eng.pool.page_occupancy()["pinned"] == 0
