"""The port's random streams against ``jax.random`` on the CPU.

``repro_torch.core.sampling`` replays JAX's threefry2x32 streams
(partitionable mode, the JAX package's setting): keys, ``fold_in``,
``split`` and random bits must equal JAX's bit for bit, including the folded
high word of seeds >= 2**32; uniforms bit for bit; Gumbel noise within 4
ulp of ``max(1, |g|)`` (``log`` may round differently from XLA's in the
last place, and near g = 0 the relative error of ``-log(-log u)`` blows up,
so the bound is absolute there).  Sampled tokens must be equal: the batched
sampler against the JAX package's ``masked_sample`` and its host
``sample_reference`` over a sweep of the sampler's knobs, and whole
requests through the port's engine against the JAX engine (given the same
weights) on ``qwen3-0.6b-toy``: seeded and unseeded, through a preemption,
and with n-gram speculation (salted streams included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import sampling as jsampling
from repro.core import spec_decode as jspec
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import build_model
from repro_torch.configs import get_config
from repro_torch.core import sampling
from repro_torch.core import spec_decode
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import Request, SamplingParams
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.tokenizer import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAS_HYPOTHESIS = True
except ImportError:          # pragma: no cover
    HAS_HYPOTHESIS = False

SEEDS = (0, 7, 1234, 2**31 + 5, 2**32 - 1, 2**32, 2**40 + 7, 2**63 - 1)
EPS32 = float(np.finfo(np.float32).eps)
GUMBEL_ULP = 4
TOK = ByteTokenizer()


def _t(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def _keys(n, seed=3):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


# --------------------------------------------------------------------------- #
# keys, bits, uniforms, Gumbel noise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    """``request_base_key`` (PRNGKey of the low word, the high word folded
    in), ``fold_in`` and ``split`` of it, bit for bit."""
    key = sampling.request_base_key(seed)
    ref = jsampling.request_base_key(seed)
    assert key.dtype == np.uint32 and key.shape == (2,)
    np.testing.assert_array_equal(key, ref)
    np.testing.assert_array_equal(
        sampling.split(key, 5), np.asarray(jax.random.split(jnp.asarray(ref),
                                                            5)))
    for data in (0, 1, 513, 2**31 + 1, 2**32 - 1):
        np.testing.assert_array_equal(
            sampling.fold_in(key, data).numpy(),
            np.asarray(jax.random.fold_in(jnp.asarray(ref), data)))
    if seed < 2**32:
        np.testing.assert_array_equal(sampling.prng_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))


def test_batched_fold_in_matches_vmap():
    """``fold_step_keys`` / ``fold_salted_keys`` against the JAX package's
    vmapped folds (the per-token and salted streams)."""
    keys = _keys(6)
    pos = np.asarray([0, 1, 17, 300, 2047, 99999], np.int32)
    np.testing.assert_array_equal(
        sampling.fold_step_keys(_t(keys), torch.from_numpy(pos).long()).numpy(),
        np.asarray(jsampling.fold_step_keys(jnp.asarray(keys),
                                            jnp.asarray(pos))))
    for salt in (spec_decode.ACCEPT_SALT, spec_decode.CORRECTION_SALT,
                 spec_decode.DRAFT_SALT):
        np.testing.assert_array_equal(
            sampling.fold_salted_keys(_t(keys), salt,
                                      torch.from_numpy(pos).long()).numpy(),
            np.asarray(jspec.fold_salted_keys(jnp.asarray(keys), salt,
                                              jnp.asarray(pos))))


@pytest.mark.parametrize("shape", [(), (7,), (3, 151936)])
def test_random_bits_match_jax(shape):
    keys = _keys(2)
    want = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), shape))
                     for k in keys])
    got = sampling.random_bits(_t(keys), shape).numpy()
    assert got.shape == (2, *shape)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 151936])
def test_uniform_bit_for_bit_and_gumbel_within_ulp(n):
    """Per-row (the sampler's vmapped ``[B, V]`` form) uniforms on [0, 1)
    and on [tiny, 1) bit for bit; Gumbel noise within the stated bound."""
    keys = _keys(3)
    tiny = float(np.finfo(np.float32).tiny)
    for lo in (0.0, tiny):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (n,), minval=lo, maxval=1.0))(jnp.asarray(keys)))
        got = sampling.uniform(_t(keys), n, lo, 1.0).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(
        jnp.asarray(keys)))
    got = sampling.gumbel(_t(keys), n).numpy()
    assert np.all(np.abs(got - want)
                  <= GUMBEL_ULP * EPS32 * np.maximum(1.0, np.abs(want)))


def test_categorical_matches_jax():
    """``categorical`` against ``vmap(jax.random.categorical)`` at the
    full vocabulary width, with masked (-inf) entries."""
    rng = np.random.default_rng(0)
    keys = _keys(8, seed=11)
    logits = (rng.standard_normal((8, 151936)) * 4).astype(np.float32)
    logits[:, ::3] = -np.inf
    want = np.asarray(jax.vmap(jax.random.categorical)(jnp.asarray(keys),
                                                       jnp.asarray(logits)))
    got = sampling.categorical(_t(keys), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# the batched sampler
# --------------------------------------------------------------------------- #
def _sample_both(logits, keys, pos, temps, top_p, top_k, min_p):
    ours = sampling.masked_sample_inner(
        torch.from_numpy(logits), _t(keys), torch.from_numpy(pos).long(),
        torch.from_numpy(temps), torch.from_numpy(top_p),
        torch.from_numpy(top_k).long(), torch.from_numpy(min_p),
        any_stochastic=bool((temps > 0).any()),
        any_mask=bool(((top_k > 0) | (top_p < 1) | (min_p > 0)).any()))
    ref = jsampling.masked_sample(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(pos),
        jnp.asarray(temps), jnp.asarray(top_p), jnp.asarray(top_k),
        jnp.asarray(min_p))
    return ours.numpy(), np.asarray(ref)


if HAS_HYPOTHESIS:
    @settings(max_examples=25, deadline=None)
    @given(temp=st.sampled_from([0.0, 0.3, 0.8, 1.5]),
           top_k=st.sampled_from([0, 1, 5, 40]),
           top_p=st.sampled_from([1.0, 0.95, 0.5, 0.1]),
           min_p=st.sampled_from([0.0, 0.05, 0.3]),
           seed=st.integers(0, 2**63 - 1))
    def test_masked_sample_tokens_match_jax(temp, top_k, top_p, min_p, seed):
        """A batch of 4 slots (one greedy) sampled at the given knobs: the
        port's tokens equal ``masked_sample``'s and, row by row, the JAX
        package's ``sample_reference`` at the folded step key."""
        rng = np.random.default_rng(seed % 2**32)
        v = 300
        logits = (rng.standard_normal((4, v)) * 3).astype(np.float32)
        keys = np.stack([jsampling.request_base_key(seed + i)
                         for i in range(4)])
        pos = rng.integers(0, 4096, 4).astype(np.int32)
        temps = np.asarray([temp, temp, temp, 0.0], np.float32)
        top_p_a = np.full(4, top_p, np.float32)
        top_k_a = np.full(4, top_k, np.int32)
        min_p_a = np.full(4, min_p, np.float32)
        ours, ref = _sample_both(logits, keys, pos, temps, top_p_a, top_k_a,
                                 min_p_a)
        np.testing.assert_array_equal(ours, ref)
        step = np.asarray(jsampling.fold_step_keys(jnp.asarray(keys),
                                                   jnp.asarray(pos)))
        for i in range(4):
            assert ours[i] == jsampling.sample_reference(
                logits[i], step[i], float(temps[i]), top_p, top_k, min_p)


# --------------------------------------------------------------------------- #
# whole requests through the engines
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def toy():
    jcfg = jax_get_config("qwen3-0.6b-toy")
    tcfg = get_config("qwen3-0.6b-toy")
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          "cpu")


def _pair(toy, **kw):
    jcfg, tcfg, jp, tp = toy
    kw.setdefault("speculative_fill", False)
    return JaxEngine(jcfg, jp, **kw), InferenceEngine(tcfg, tp, device="cpu",
                                                      **kw)


def _reqs(prompts, samplings, **kw):
    return ([JaxRequest(prompt_tokens=TOK.encode(p),
                        sampling=JaxSampling(**s), **kw)
             for p, s in zip(prompts, samplings)],
            [Request(prompt_tokens=TOK.encode(p),
                     sampling=SamplingParams(**s), **kw)
             for p, s in zip(prompts, samplings)])


def _same(jr, tr):
    for a, b in zip(jr, tr):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason.value == a.finish_reason.value


STOCH = [dict(max_tokens=12, temperature=0.9, top_p=0.9, seed=1234),
         dict(max_tokens=12, temperature=1.2),
         dict(max_tokens=12, temperature=0.7, top_k=20, seed=2**40 + 3),
         dict(max_tokens=12, temperature=0.8, min_p=0.05),
         dict(max_tokens=12)]
PROMPTS = ["a seeded request", "an unseeded one", "high word seed",
           "min-p sampled", "greedy neighbour"]


def test_seeded_and_unseeded_requests_match_jax_engine(toy):
    """Five requests on 3 slots, decode blocks of 4: seeded (low and high
    seed words), unseeded (the engines' key chains, split per add) and a
    greedy neighbour all give the JAX engine's tokens."""
    je, te = _pair(toy, max_batch=3, cache_len=128, max_decode_block=4)
    jr, tr = _reqs(PROMPTS, STOCH)
    je.generate(jr)
    te.generate(tr)
    _same(jr, tr)
    for r in tr:
        np.testing.assert_array_equal(
            r.sample_key, next(a for a in jr if a.prompt_tokens
                               == r.prompt_tokens).sample_key)
    assert len(set(tr[1].output_tokens)) > 1


def test_preempted_stochastic_requests_match_jax_engine(toy):
    """max_batch 1, EDF with preemption: a seeded and an unseeded
    stochastic batch request evicted by an urgent one resume their streams
    with the JAX engine's tokens."""
    je, te = _pair(toy, max_batch=1, cache_len=128, sched_policy="edf",
                   preemption=True)
    jr, tr = _reqs(PROMPTS[:2], [dict(STOCH[0], max_tokens=20),
                                 dict(STOCH[1], max_tokens=20)])
    for eng, rs in ((je, jr), (te, tr)):
        eng.add_request(rs[0])
        eng.add_request(rs[1])
        for _ in range(4):
            eng.step()
    ju, tu = _reqs(["urgent!"], [dict(max_tokens=4, temperature=0.5)],
                   deadline_ms=1.0)
    je.add_request(ju[0])
    te.add_request(tu[0])
    while je.scheduler.has_work or te.scheduler.has_work:
        je.step()
        te.step()
    assert te.scheduler.stats.preemptions >= 1
    assert te.scheduler.stats.preemptions == je.scheduler.stats.preemptions
    _same(jr + ju, tr + tu)


def test_seeded_ngram_speculation_matches_jax_engine(toy):
    """n-gram speculation (spec_k 4): a repetition-heavy greedy row, a
    seeded stochastic row and an unseeded one emit the JAX engine's
    tokens, with the same speculation counters."""
    je, te = _pair(toy, max_batch=3, cache_len=256, spec_mode="ngram",
                   spec_k=4, enable_prefix_cache=False)
    rep = "the cat sat on the mat and the cat sat on the mat again and "
    samp = [dict(max_tokens=24),
            dict(max_tokens=24, temperature=0.9, top_p=0.9, seed=42),
            dict(max_tokens=24, temperature=0.6)]
    jr, tr = _reqs([rep, "zq pw lx " + rep, "pw " + rep], samp)
    je.generate(jr)
    te.generate(tr)
    _same(jr, tr)
    js, ts = je.spec_stats, te.spec_stats
    assert ts.rounds > 0 and ts.accepted > 0
    assert ts.snapshot() == js.snapshot()
