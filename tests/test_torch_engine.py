"""The port's engine against the JAX package's ``InferenceEngine`` on the
CPU, given the same weights (bridged from one JAX init): greedy tokens must
be identical — with ``prefill_chunk`` 0 and 32, with more requests than
``max_batch``, with stop tokens, ``max_tokens`` and an abort, with decode
blocks of K 1, 3 and 8 — and logprobs close (atol 1e-4, float32); and
greedy tokens of the paper's dense stand-ins ``gemma3-4b-toy`` (sliding
window, prompt longer than the ring) and ``llama-3.2-1b-toy``.  Both engines run with the same arguments,
the prefix cache on, speculative wave filling off (its parity with the
JAX engine is ``tests/test_torch_fill_groups_echo.py``'s).  Also the sampler: the keep-set semantics against the
reference's, and the stateless per-token stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import sampling as jsampling
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import build_model
from repro_torch.configs import AudioConfig, get_config
from repro_torch.core import sampling
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import FinishReason, Request, SamplingParams
from repro_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

PROMPT_LENS = (5, 40, 70, 17, 3)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          "cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 256, size=n)] for n in PROMPT_LENS]


def _engines(weights, **kw):
    """Both engines with the same arguments (the prefix cache on, as by
    default); speculative wave filling is off on both sides."""
    jcfg, tcfg, jp, tp = weights
    kw.setdefault("enable_prefix_cache", True)
    kw.setdefault("speculative_fill", False)
    je = JaxEngine(jcfg, jp, **kw)
    te = InferenceEngine(tcfg, tp, device="cpu", **kw)
    return je, te


def _requests(sampling_kw):
    """The same prompts and sampling parameters for both engines."""
    return ([JaxRequest(prompt_tokens=p, sampling=JaxSampling(**kw))
             for p, kw in zip(_prompts(), sampling_kw)],
            [Request(prompt_tokens=p, sampling=SamplingParams(**kw))
             for p, kw in zip(_prompts(), sampling_kw)])


def _same_outcome(jr, tr):
    for a, b in zip(jr, tr):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason.value == a.finish_reason.value
        assert b.output_text == a.output_text


@pytest.mark.parametrize("prefill_chunk", [0, 32])
def test_greedy_tokens_match_reference(weights, prefill_chunk):
    """5 requests on 2 slots, prompts over and under the chunk size."""
    je, te = _engines(weights, max_batch=2, cache_len=128,
                      prefill_chunk=prefill_chunk)
    kw = [{"max_tokens": m} for m in (12, 7, 10, 16, 1)]
    jr, tr = _requests(kw)
    je.generate(jr)
    te.generate(tr)
    _same_outcome(jr, tr)
    assert te.scheduler.stats.peak_batch == 2
    assert all(r.finish_reason is FinishReason.LENGTH for r in tr)


@pytest.fixture(scope="module")
def family_weights():
    """Bridged weights of the paper's dense stand-ins, made on first use."""
    made = {}

    def get(name):
        if name not in made:
            jcfg, tcfg = jax_get_config(name), get_config(name)
            jp = build_model(jcfg).init(jax.random.PRNGKey(0))
            made[name] = (jcfg, tcfg, jp, params_from_jax(
                jax.tree.map(np.asarray, jp), tcfg, "cpu"))
        return made[name]

    return get


@pytest.mark.parametrize("arch,cache_len,prefill_chunk", [
    ("gemma3-4b-toy", 256, 0), ("gemma3-4b-toy", 256, 128),
    ("llama-3.2-1b-toy", 128, 32)])
def test_dense_family_greedy_tokens_match_reference(family_weights, arch,
                                                    cache_len, prefill_chunk):
    """``gemma3-4b-toy`` (a 256-token sliding window over a 256-slot ring)
    with a 600-token prompt, which both engines prefill in ring-sized
    chunks even when ``prefill_chunk`` is 0 (its queries past position 510
    see no key inside the window: the reference's mean of V), beside
    shorter prompts; and ``llama-3.2-1b-toy`` (tied embeddings, G = 4)."""
    je, te = _engines(family_weights(arch), max_batch=2, cache_len=cache_len,
                      prefill_chunk=prefill_chunk)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, 256, size=n)]
               for n in (600, 40, 9)]
    if arch == "llama-3.2-1b-toy":
        prompts[0] = prompts[0][:100]
    kw = [{"max_tokens": m} for m in (10, 6, 12)]
    jr = [JaxRequest(prompt_tokens=p, sampling=JaxSampling(**k))
          for p, k in zip(prompts, kw)]
    tr = [Request(prompt_tokens=p, sampling=SamplingParams(**k))
          for p, k in zip(prompts, kw)]
    je.generate(jr)
    te.generate(tr)
    _same_outcome(jr, tr)
    assert all(r.finish_reason is FinishReason.LENGTH for r in tr)


def test_stop_tokens_and_abort_match_reference(weights):
    """Stop tokens taken from the greedy stream, then an abort of one live
    request after three engine steps in both engines."""
    je, te = _engines(weights, max_batch=3, cache_len=128, prefill_chunk=32)
    free = _requests([{"max_tokens": 12}] * 5)[1]
    InferenceEngine(te.cfg, te.params, device="cpu", max_batch=3,
                    cache_len=128).generate(free)
    kw = [{"max_tokens": 12, "stop_token_ids": (r.output_tokens[4],)}
          for r in free]
    jr, tr = _requests(kw)
    for eng, reqs in ((je, jr), (te, tr)):
        for r in reqs:
            eng.add_request(r)
        for _ in range(3):
            eng.step()
        assert eng.abort(reqs[1].request_id)
        eng.run()
    _same_outcome(jr, tr)
    assert tr[1].finish_reason is FinishReason.ABORT
    assert any(r.finish_reason is FinishReason.STOP for r in tr)
    assert te.abort(tr[1].request_id) == []          # abort after finish


def test_logprobs_match_reference(weights):
    je, te = _engines(weights, max_batch=2, cache_len=128, prefill_chunk=32)
    jr, tr = _requests([{"max_tokens": 6, "logprobs": True,
                         "top_logprobs": 3}] * 3)
    je.generate(jr)
    te.generate(tr)
    _same_outcome(jr, tr)
    for a, b in zip(jr, tr):
        for (la, ta), (lb, tb) in zip(a.output_logprobs, b.output_logprobs):
            assert lb == pytest.approx(la, abs=1e-4)
            assert [t for t, _ in tb] == [t for t, _ in ta]
            np.testing.assert_allclose([v for _, v in tb], [v for _, v in ta],
                                       atol=1e-4)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_decode_block_matches_reference_across_k(weights, k):
    """The decode block's steps over the runner's static buffers (eager on
    the CPU) against the reference's compiled block at K 1, 3 and 8, with
    logprobs: stop tokens and budgets end slots inside a block, and queued
    requests take the freed slots.  Tokens identical, logprobs within
    1e-4."""
    je, te = _engines(weights, max_batch=3, cache_len=128, prefill_chunk=32,
                      max_decode_block=k)
    free = _requests([{"max_tokens": 12}] * 5)[1]
    InferenceEngine(te.cfg, te.params, device="cpu", max_batch=3,
                    cache_len=128).generate(free)
    kw = [{"max_tokens": m, "logprobs": True, "top_logprobs": 2,
           "stop_token_ids": (free[i].output_tokens[5],) if i % 2 else ()}
          for i, m in enumerate((12, 11, 5, 16, 9))]
    jr, tr = _requests(kw)
    je.generate(jr)
    te.generate(tr)
    _same_outcome(jr, tr)
    assert any(r.finish_reason is FinishReason.STOP for r in tr)
    assert te.scheduler.stats.decode_graph_steps == 0
    for a, b in zip(jr, tr):
        assert len(b.output_logprobs) == len(a.output_logprobs)
        for (la, ta), (lb, tb) in zip(a.output_logprobs, b.output_logprobs):
            assert lb == pytest.approx(la, abs=1e-4)
            assert [t for t, _ in tb] == [t for t, _ in ta]
            np.testing.assert_allclose([v for _, v in tb], [v for _, v in ta],
                                       atol=1e-4)


def test_engine_needs_cuda_unless_cpu_is_asked_for(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(weights[1], weights[3])
    # the audio family builds on the CPU when asked (ported, as the SSM
    # families are)
    audio = InferenceEngine(audio_config(), device="cpu", cache_len=64)
    assert audio.media_kind == "audio" and audio.ctx_len == 16


def audio_config():
    """An audio encoder-decoder config (the reference's is
    ``seamless-m4t-medium``)."""
    return dataclasses.replace(get_config("qwen3-0.6b-toy"), family="audio",
                               audio=AudioConfig(embed_dim=64, num_frames=16,
                                                 encoder_layers=2))


def test_requests_outside_the_slice_are_refused(weights):
    """A text model ignores media, as the reference does; ``n`` > 1 with
    media on a vision model is accepted (its choices admit on their own,
    as in the reference), and so is ``echo`` on a text prompt, while
    ``echo`` with media is refused, as the reference refuses it."""
    te = InferenceEngine(weights[1], weights[3], device="cpu", cache_len=64)
    te.add_request(Request(prompt_tokens=[1, 2], images=[np.zeros(3)]))
    vision = InferenceEngine(get_config("qwen3-vl-toy"), device="cpu",
                             cache_len=64)
    vision.add_request(Request(prompt_tokens=[1, 2], group_size=2,
                               images=[np.zeros((4, 4, 3))]))
    assert vision.group_stats["groups"] == 1
    with pytest.raises(ValueError, match="echo"):
        vision.add_request(Request(prompt_tokens=[1, 2],
                                   images=[np.zeros((4, 4, 3))],
                                   sampling=SamplingParams(echo=True)))
    te.add_request(Request(prompt_tokens=[1, 2],
                           sampling=SamplingParams(echo=True, logprobs=True)))
    with pytest.raises(ValueError, match="KV cache holds"):
        te.add_request(Request(prompt_tokens=list(range(65))))
    with pytest.raises(ValueError, match="top_p"):
        te.add_request(Request(prompt_tokens=[1],
                               sampling=SamplingParams(top_p=0.0)))


# --------------------------------------------------------------------------- #
# sampler
# --------------------------------------------------------------------------- #
def test_mask_semantics_match_reference_keep_set():
    """The port's keep-set equals the reference's (its batched masks and
    its host reference sampler's draws) for random logits and knobs."""
    rng = np.random.default_rng(5)
    b, v = 64, 300
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, b).astype(np.float32)
    top_p = np.where(rng.random(b) < 0.5, rng.uniform(0.05, 1.0, b), 1.0
                     ).astype(np.float32)
    top_k = np.where(rng.random(b) < 0.5, rng.integers(1, v + 50, b), 0)
    min_p = np.where(rng.random(b) < 0.5, rng.uniform(0, 0.5, b), 0.0
                     ).astype(np.float32)
    scaled = logits / temps[:, None]
    ours = sampling.mask_scaled_logits(
        torch.from_numpy(scaled), torch.from_numpy(top_p),
        torch.from_numpy(top_k), torch.from_numpy(min_p)).numpy()
    ref = np.asarray(jsampling.mask_scaled_logits(
        jnp.asarray(scaled), jnp.asarray(top_p), jnp.asarray(top_k, jnp.int32),
        jnp.asarray(min_p)))
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))
    for i in range(0, b, 8):
        keep = sampling.keep_set_reference(logits[i], temps[i], top_p[i],
                                           top_k[i], min_p[i])
        np.testing.assert_array_equal(keep, np.isfinite(ours[i]))
        for key in range(3):
            tok = jsampling.sample_reference(
                logits[i], np.asarray(jax.random.PRNGKey(key)), temps[i],
                top_p[i], top_k[i], min_p[i])
            assert keep[tok]


def test_sampler_draws_follow_the_distribution():
    """Gumbel-max over the threefry noise samples softmax(logits / T)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    keys = torch.from_numpy(
        sampling.split(sampling.prng_key(0), 4000).astype(np.int64))
    toks = sampling.masked_sample_inner(
        logits, keys, torch.full((4000,), 3), torch.ones(4000),
        torch.ones(4000), torch.zeros(4000, dtype=torch.int64),
        torch.zeros(4000), any_mask=False)
    freq = torch.bincount(toks, minlength=4).float() / 4000
    torch.testing.assert_close(freq, torch.softmax(logits[0], -1),
                               atol=0.03, rtol=0)


def test_stateless_stream_across_block_size_and_batch(weights):
    """Seeded sampled tokens depend only on (seed, position): the same for
    decode blocks of K = 1 and 4, and alone or beside other requests."""
    tcfg, tp = weights[1], weights[3]

    def run(k, prompts):
        eng = InferenceEngine(tcfg, tp, device="cpu", max_batch=4,
                              cache_len=128, max_decode_block=k)
        reqs = [Request(prompt_tokens=p, sampling=SamplingParams(
            temperature=0.9, top_p=0.95, top_k=50, max_tokens=10, seed=11))
            for p in prompts]
        eng.generate(reqs)
        return reqs[0].output_tokens

    prompts = _prompts()
    alone_k1 = run(1, prompts[:1])
    assert run(4, prompts[:1]) == alone_k1
    assert run(4, prompts[:3]) == alone_k1
    assert run(1, prompts[:4]) == alone_k1
    greedy = InferenceEngine(tcfg, tp, device="cpu", cache_len=128)
    r = Request(prompt_tokens=prompts[0], sampling=SamplingParams(max_tokens=10))
    greedy.generate([r])
    assert r.output_tokens != alone_k1                # the stream is random


def test_pool_rows_and_the_shared_zeros_cache(weights):
    """insert_many/read round-trip a wave of rows, and serving never writes
    into the shared zeros cache that every fresh prefill job starts from."""
    from repro_torch.models.model import tree_leaves, tree_map
    te = InferenceEngine(weights[1], weights[3], device="cpu", max_batch=3,
                         cache_len=96, prefill_chunk=16)
    te.generate(_requests([{"max_tokens": 4}] * 5)[1][:4])
    zeros = te.pool.single_cache_zeros()
    assert not any(leaf.any() for leaf in tree_leaves(zeros))
    rows = [tree_map(lambda a, i=i: torch.full_like(a, i + 1.0), zeros)
            for i in range(2)]
    te.pool.insert_many([2, 0], rows)
    for slot, value in ((2, 1.0), (0, 2.0)):
        assert all(bool((leaf == value).all())
                   for leaf in tree_leaves(te.pool.read(slot)))
