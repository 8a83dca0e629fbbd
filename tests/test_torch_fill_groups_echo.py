"""Speculative wave filling, shared-prefix ``n`` groups and echo prompt
logprobs of the port against the JAX package's engine on the CPU, given the
same weights (``qwen2-0.5b`` reduced, float32, bridged from one JAX init).

The two engines step in lockstep, and after every step they must agree on
the live slots, the speculative jobs and the ``spec_*`` / wave counters,
``group_stats``, the prefix-cache counters and, on pages, page ids,
refcounts, the free list and ``PageStats``; at the end on every greedy
token.  Spec fill costs no extra forward: the port's prefill forwards equal
``prefill_waves``, and a spec-off run gives the same tokens.  A group
prefills its prompt once (shared admits, 0 full copies on pages); a leader
aborted before its commit turns its followers independent; an ``n`` = 2
image request admits independently with one encoder call.  Prompt
logprobs match the JAX engine's within 1e-5 and, at three cut points, the
log-softmax of a prefill of the prefix.  The scenarios are those of
``tests/test_sched_policy.py`` and ``tests/test_router.py``.
"""
import dataclasses
import logging
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import GenerationRequest, Request, SamplingParams
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import init_cache
from repro_torch.serving import media
from repro_torch.serving.client import EngineClient
from repro_torch.serving.tokenizer import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401

TOK = ByteTokenizer()
LONG = ("speculative wave filling lets padding rows of a prefill wave carry "
        "the chunks of requests that have no slot yet, ") * 2
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", kv_page_size=16)}


@pytest.fixture(scope="module", autouse=True)
def quiet():
    """Aborts, faults and bucket compiles log warnings."""
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (CPU tests only)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.core.engine import InferenceEngine as JaxEngine
    from repro.core.request import Request as JaxRequest
    from repro.core.request import SamplingParams as JaxSampling
    from repro.models import build_model
    return types.SimpleNamespace(jax=jax, Engine=JaxEngine,
                                 Request=JaxRequest,
                                 SamplingParams=JaxSampling,
                                 get_config=jax_get_config,
                                 build_model=build_model)


@pytest.fixture(scope="module")
def weights(jx):
    """(JAX config, port config, JAX params, port params), float32."""
    jcfg = dataclasses.replace(jx.get_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    jp = jx.build_model(jcfg).init(jx.jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jx.jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


class Pair:
    """The JAX engine and the port's with the same arguments, stepped in
    lockstep; ``req`` makes the same request (pinned id) for both."""

    def __init__(self, jx, weights, **kw):
        jcfg, tcfg, jp, tp = weights
        self.jx = jx
        self.je = jx.Engine(jcfg, jp, **kw)
        self.te = InferenceEngine(tcfg, tp, device="cpu", **kw)
        self.prefill_calls = 0
        real = self.te._prefill

        def counted(*a, **k):
            self.prefill_calls += 1
            return real(*a, **k)
        self.te._prefill = counted

    def req(self, rid, tokens, max_tokens=5, **kw):
        return (self.jx.Request(prompt_tokens=list(tokens), request_id=rid,
                                sampling=self.jx.SamplingParams(
                                    max_tokens=max_tokens), **kw),
                Request(prompt_tokens=list(tokens), request_id=rid,
                        sampling=SamplingParams(max_tokens=max_tokens), **kw))

    def add(self, pairs):
        for jr, tr in pairs:
            self.je.add_request(jr)
            self.te.add_request(tr)

    def step(self):
        self.je.step()
        self.te.step()
        self.check()

    def run(self):
        while self.te.scheduler.has_work or self.je.scheduler.has_work:
            self.step()

    def check(self):
        je, te = self.je, self.te
        js, ts = je.scheduler.stats, te.scheduler.stats
        fields = ("spec_jobs", "spec_chunks", "spec_admitted",
                  "prefill_waves", "prefill_chunks", "aborted", "failed")
        assert [getattr(ts, f) for f in fields] == \
            [getattr(js, f) for f in fields]
        assert te._live_slots == je._live_slots
        assert set(te._spec_jobs) == set(je._spec_jobs)
        assert te.group_stats == je.group_stats
        assert te._job_leases == je._job_leases
        if te.prefix_cache is not None:
            assert vars(te.prefix_cache.stats) == vars(je.prefix_cache.stats)
        if te._paged:
            jp, tp = je.pool, te.pool
            assert tp._slot_pages == jp._slot_pages
            assert tp.allocator._ref == jp.allocator._ref
            assert tp.allocator._free == jp.allocator._free
            assert vars(tp.stats) == vars(jp.stats)


def _staggered(n):
    """Staggered chunked prompts keep wave sizes off powers of two, so the
    waves carry padding rows."""
    return [TOK.encode(LONG[:40 + 18 * i] + f" tail {i}") for i in range(n)]


# --------------------------------------------------------------------------- #
# speculative wave filling
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_fill_step_for_step(jx, weights, layout):
    """Ten staggered prompts on five slots, chunked at 32, the prefix
    cache on (partial prefixes publish): the JAX engine and the port agree
    step by step; one pending request is aborted while its speculative job
    is in flight.  The port's prefill forwards equal its waves (a backfilled
    row replaces a padding row), and spec fill off gives the same tokens."""
    kw = dict(max_batch=5, cache_len=256, prefill_chunk=32, seed=0,
              **LAYOUTS[layout])
    p = Pair(jx, weights, **kw)
    pairs = [p.req(7000 + i, t) for i, t in enumerate(_staggered(10))]
    p.add(pairs)
    aborted = None
    while p.te.scheduler.has_work or p.je.scheduler.has_work:
        p.step()
        if aborted is None and p.te._spec_jobs and \
                p.te.scheduler.stats.spec_chunks >= 2:
            aborted = max(p.te._spec_jobs)
            assert p.je.abort(aborted) and p.te.abort(aborted)
            p.check()
    assert aborted is not None
    s = p.te.scheduler.stats
    assert s.spec_jobs > 0 and s.spec_chunks > 0 and s.spec_admitted > 0
    assert p.prefill_calls == s.prefill_waves
    for jr, tr in pairs:
        assert tr.output_tokens == jr.output_tokens
        assert tr.finish_reason.value == jr.finish_reason.value
    assert not p.te._spec_jobs and not p.te._job_leases
    if layout == "dense":
        off = InferenceEngine(weights[1], weights[3], device="cpu",
                              speculative_fill=False, **kw)
        reqs = [Request(prompt_tokens=t, sampling=SamplingParams(max_tokens=5))
                for t in _staggered(10)]
        off.generate(reqs)
        for r, (_, tr) in zip(reqs, pairs):
            if tr.request_id != aborted:
                assert tr.output_tokens == r.output_tokens
    else:
        assert p.te.pool.page_occupancy()["pinned"] == 0


def test_spec_fill_publishes_partial_prefixes(weights):
    """A speculated request's chunks land in the prefix cache before it is
    admitted (three chunked hogs keep waves at 3 rows, so one padding row
    a wave carries the pending request)."""
    eng = InferenceEngine(weights[1], weights[3], device="cpu", max_batch=3,
                          cache_len=256, prefill_chunk=32,
                          prefix_block_size=8)
    hogs = [Request(prompt_tokens=TOK.encode("slot hog " * (8 + 4 * i)),
                    sampling=SamplingParams(max_tokens=24)) for i in range(3)]
    for hog in hogs:
        eng.add_request(hog)
    eng.step()
    long = TOK.encode(LONG)
    waiting = Request(prompt_tokens=long,
                      sampling=SamplingParams(max_tokens=4))
    eng.add_request(waiting)
    for _ in range(6):
        eng.step()
    assert eng.scheduler.stats.spec_chunks > 0
    probe, matched = eng.prefix_cache.lookup(long, max_len=len(long))
    assert probe is not None and matched >= 8
    eng.run()
    assert waiting.is_finished and waiting.finish_reason.value == "length"


# --------------------------------------------------------------------------- #
# shared-prefix n groups
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def group_pairs(jx, weights):
    """One lockstep pair per layout with the prefix cache off (a group's
    share comes from the group table alone), reused by the group and echo
    cases: the two engines of a pair always share their history."""
    return {layout: Pair(jx, weights, max_batch=6, cache_len=256,
                         prefill_chunk=64, enable_prefix_cache=False, **kw)
            for layout, kw in LAYOUTS.items()}


def _group_delta(p, before):
    return {k: v - before[k] for k, v in p.te.group_stats.items()}


def _group(p, rid, tokens, n, max_tokens=6):
    """n requests of one group (the leader's id first), for both engines."""
    return [p.req(rid + i, tokens, max_tokens, group_size=n,
                  group_leader=None if i == 0 else rid) for i in range(n)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_group_step_for_step(group_pairs, layout):
    """n = 4 behind a long system prompt, the prefix cache off (the share
    comes from the group table), beside an n = 1 request of the same
    prompt: one prefill of the shared prompt, three shared admits, zero
    full copies on pages, every choice equal to the n = 1 one and to the
    JAX engine's."""
    p = group_pairs[layout]
    before = dict(p.te.group_stats)
    prompt = TOK.encode("<|system|>" + LONG[:150] + "<|user|>hi<|assistant|>")
    group = _group(p, 7100, prompt, 4)
    solo = p.req(7200, prompt, 6)
    p.add(group)
    p.run()
    p.add([solo])
    p.run()
    assert _group_delta(p, before) == {"groups": 1, "shared_admits": 3,
                                       "independent_fallbacks": 0}
    outs = [tr.output_tokens for _, tr in group]
    assert all(o == solo[1].output_tokens for o in outs)
    for jr, tr in group + [solo]:
        assert tr.output_tokens == jr.output_tokens
        assert tr.cached_prefix_len == jr.cached_prefix_len
    assert [tr.cached_prefix_len for _, tr in group] == \
        [0] + [len(prompt) - 1] * 3
    if layout == "paged":
        assert p.te.pool.stats.full_copies == 0
        assert p.te.pool.page_occupancy()["pinned"] == 0
    assert not p.te._prefill_groups


def test_group_leader_abort_falls_back(group_pairs):
    """A leader aborted before its commit: the followers admit on their
    own (independent fallbacks), as in the JAX engine."""
    p = group_pairs["dense"]
    before = dict(p.te.group_stats)
    group = _group(p, 7300, TOK.encode(LONG), 3, max_tokens=4)
    p.add(group)
    p.step()
    assert p.je.abort(7300) and p.te.abort(7300)
    p.run()
    assert _group_delta(p, before) == {"groups": 1, "shared_admits": 0,
                                       "independent_fallbacks": 2}
    for jr, tr in group[1:]:
        assert tr.output_tokens == jr.output_tokens
    assert group[0][1].finish_reason.value == "abort"


def test_group_with_media_admits_independently():
    """n = 2 with an image (no longer refused): the choices admit on their
    own — the group value carries no context rows — and the content cache
    collapses their encodes to one encoder call."""
    eng = InferenceEngine(get_config("qwen3-vl-toy"), device="cpu",
                          max_batch=2, cache_len=128, vision_work_iters=1)
    image = media.encode_b64((np.arange(8 * 8 * 3) % 251)
                             .reshape(8, 8, 3).astype(np.uint8))
    with EngineClient(eng) as client:
        res = client.submit(GenerationRequest(
            prompt="describe", n=2, images=[image],
            sampling=SamplingParams(max_tokens=4))).result(timeout=120)
    assert res.choices[0].tokens == res.choices[1].tokens
    assert eng.content_cache_stats()["encoder_invocations"] == 1
    assert eng.group_stats["shared_admits"] == 0


# --------------------------------------------------------------------------- #
# echo / prompt logprobs
# --------------------------------------------------------------------------- #
def test_echo_prompt_logprobs(group_pairs, weights):
    """Prompt logprobs of an echo request equal the JAX engine's within
    1e-5, and at three cut points i the log-softmax of the last row of a
    prefill of ``toks[:i]``, at ``toks[i]``.  Echo with an image raises."""
    p, tcfg, tp = group_pairs["dense"], weights[1], weights[3]
    te = p.te
    toks = TOK.encode(LONG[:150])
    jr = p.jx.Request(prompt_tokens=toks, request_id=7400,
                      sampling=p.jx.SamplingParams(max_tokens=3,
                                                   logprobs=True, echo=True))
    tr = Request(prompt_tokens=toks, request_id=7400, sampling=SamplingParams(
        max_tokens=3, logprobs=True, echo=True))
    p.add([(jr, tr)])
    p.run()
    assert tr.output_tokens == jr.output_tokens
    assert tr.prompt_logprobs[0] is None and jr.prompt_logprobs[0] is None
    assert len(tr.prompt_logprobs) == len(toks)
    np.testing.assert_allclose(tr.prompt_logprobs[1:], jr.prompt_logprobs[1:],
                               rtol=0, atol=1e-5)
    for i in (5, len(toks) // 2, len(toks) - 1):
        out = te.model.apply(tp, torch.tensor([toks[:i]]), mode="prefill",
                             cache=init_cache(tcfg, 1, 256, device="cpu"),
                             logits_mode="last")
        want = torch.log_softmax(out.logits[0, -1].float(), -1)[toks[i]]
        assert abs(tr.prompt_logprobs[i] - float(want)) <= 1e-5
    with pytest.raises(ValueError, match="echo"):
        te.validate_request(Request(
            prompt_tokens=toks, images=[{"base64": ""}],
            sampling=SamplingParams(echo=True, logprobs=True)))
