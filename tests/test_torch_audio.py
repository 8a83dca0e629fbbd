"""The port's audio encoder-decoder against the JAX package on the CPU,
given the same weights (bridged from one JAX init, float32):
``seamless-m4t-medium`` reduced (2 encoder and 2 decoder layers, 16 frames
of 64-wide embeddings).

The encoder output (``audio_proj``, the causal encoder stack, ``enc_ln``),
``Model.apply`` logits in train, prefill (fresh, and cross-cached with the
encoder's ``xk``/``xv`` injected) and decode; then the engine's greedy
tokens and :class:`MediaStats` for one waveform shared by concurrent
requests (one encoder call, dedup joins, cross-KV hits, lease pages on the
paged layout) and a warm repeat, on the dense ring and on pages.

Tolerances: encoder output and logits atol 1e-4 (float32 summed in another
order); tokens and counters exact.  Both engines take the same arguments,
speculative wave filling off.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import Request, SamplingParams
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

NAME = "seamless-m4t-medium"
ATOL = dict(atol=1e-4, rtol=1e-4)
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", kv_page_size=16)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or ATOL))


@pytest.fixture(scope="module")
def audio():
    jcfg = dataclasses.replace(jax_get_config(NAME).reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(NAME).reduced(), dtype="float32")
    jp = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.audio.num_frames, cfg.audio.embed_dim)).astype(np.float32)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def test_audio_params_and_caches_match_reference_shapes(audio):
    jcfg, tcfg, _, tp = audio
    shapes = dict(_leaves(jmodel.build_model(jcfg).init_shapes()))
    ours = dict(_leaves(model.Model(tcfg).init(
        torch.Generator().manual_seed(0), "cpu")))
    for tree in (ours, dict(_leaves(tp))):
        assert tree.keys() == shapes.keys()
        for key, sds in shapes.items():
            assert tuple(tree[key].shape) == sds.shape, key
    ctx = jcfg.audio.num_frames
    jc = dict(_leaves(jmodel.init_cache(jcfg, 2, 24, ctx_len=ctx)))
    tc = dict(_leaves(model.init_cache(tcfg, 2, 24, ctx_len=ctx,
                                       device="cpu")))
    assert tc.keys() == jc.keys() and any(k.endswith("/xk") for k in tc)
    for key, leaf in jc.items():
        assert tuple(tc[key].shape) == leaf.shape, key


def test_encoder_matches_reference(audio):
    """``encode_audio``: the projection, the causal encoder stack, the
    final norm."""
    jcfg, tcfg, jp, tp = audio
    fr = _frames(jcfg, 2, 1)
    want = jmodel.build_model(jcfg)._encode_audio(jp, fr, "full")
    got = model.Model(tcfg).encode_audio(tp, torch.from_numpy(fr))
    _close(got, want)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_audio_model_logits_match_reference(audio, mode):
    """Train logits; a resume prefill of right-padded rows with the
    encoder run, then the same prefill with the cross KV injected
    (``cross_cached``, no encoder) and three decode steps."""
    jcfg, tcfg, jp, tp = audio
    jm, tm = jmodel.build_model(jcfg), model.Model(tcfg)
    japply = jax.jit(jm.apply, static_argnames=("mode", "resume",
                                                "cross_cached"))
    rng = np.random.default_rng(3)
    b, s, cache_len, ctx = 2, 20, 40, jcfg.audio.num_frames
    toks = rng.integers(0, jcfg.vocab_size, (b, s))
    fr = _frames(jcfg, b, 2)
    cv = np.ones((b, ctx), bool)
    cv[1, 11:] = False
    if mode == "train":
        _close(tm.apply(tp, torch.from_numpy(toks), mode="train",
                        audio_frames=torch.from_numpy(fr)).logits,
               japply(jp, toks, mode="train", audio_frames=fr).logits)
        return
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    sv = pos < np.array([[s], [13]])
    args = dict(mode="prefill", positions=pos, resume=True, seq_valid=sv,
                ctx_valid=cv)
    targs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in args.items()}
    jc = jmodel.init_cache(jcfg, b, cache_len, ctx_len=ctx)
    tc = model.init_cache(tcfg, b, cache_len, ctx_len=ctx, device="cpu")
    jout = japply(jp, toks, cache=jc, audio_frames=fr, **args)
    tout = tm.apply(tp, torch.from_numpy(toks), cache=tc,
                    audio_frames=torch.from_numpy(fr), **targs)
    _close(tout.logits, jout.logits)
    # the same prefill from a cache holding only the cross KV: no encoder
    warm = model.init_cache(tcfg, b, cache_len, ctx_len=ctx, device="cpu")
    for (key, dst), (_, src) in zip(_leaves(warm), _leaves(tc)):
        if key.endswith(("/xk", "/xv")):
            dst.copy_(src)
    calls = []
    real = tm.encode_audio
    object.__setattr__(tm, "encode_audio",
                       lambda *a: calls.append(1) or real(*a))
    hot = tm.apply(tp, torch.from_numpy(toks), cache=warm, cross_cached=True,
                   **targs)
    assert not calls
    _close(hot.logits, jout.logits)
    if mode == "prefill":
        for (key, a), (_, t) in zip(_leaves(jout.cache), _leaves(tc)):
            _close(t, a)
        return
    jc = jout.cache
    nxt = np.asarray(jout.logits)[np.arange(b), [s - 1, 12]].argmax(-1)
    p = np.array([s, 13])
    for _ in range(3):
        jout = japply(jp, nxt[:, None], mode="decode", positions=p[:, None],
                      cache=jc, ctx_valid=cv)
        jc = jout.cache
        tout = tm.apply(tp, torch.from_numpy(nxt[:, None]), mode="decode",
                        positions=torch.from_numpy(p[:, None]), cache=tc,
                        ctx_valid=torch.from_numpy(cv))
        _close(tout.logits, jout.logits)
        nxt, p = np.asarray(jout.logits)[:, 0].argmax(-1), p + 1


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
def _req(cls, samp, tokens, wave, n=8):
    return cls(prompt_tokens=list(tokens), sampling=samp(max_tokens=n),
               audio=wave)


@pytest.mark.parametrize("layout,prefix_cache", [("dense", True),
                                                 ("paged", True),
                                                 ("paged", False)])
def test_engine_tokens_and_media_stats_match_reference(audio, layout,
                                                       prefix_cache):
    """Round 1: 4 concurrent requests, three with one waveform and one
    text-only, on 2 slots; round 2: the waveform again (an embedding hit
    and a cross-KV hit, no encoder call) and a second waveform.  Tokens,
    ``MediaStats`` and (paged) ``PageStats`` equal the JAX engine's after
    each round, and so do the prefix cache's counters."""
    jcfg, tcfg, jp, tp = audio
    kw = dict(max_batch=2, cache_len=128, prefill_chunk=32,
              vision_work_iters=1, speculative_fill=False,
              enable_prefix_cache=prefix_cache, **LAYOUTS[layout])
    je = JaxEngine(jcfg, jp, **kw)
    te = InferenceEngine(tcfg, tp, device="cpu", **kw)
    rng = np.random.default_rng(5)
    wave = rng.standard_normal(2000).astype(np.float32)
    other = rng.standard_normal(900).astype(np.float32)
    prompts = [[int(t) for t in rng.integers(1, 256, size=n)]
               for n in (9, 30, 45, 12)]
    rounds = [[(prompts[0], wave), (prompts[1], wave), (prompts[2], None),
               (prompts[3], wave)],
              [(prompts[1], wave), (prompts[2], other)]]
    for traffic in rounds:
        jr = [_req(JaxRequest, JaxSampling, t, w) for t, w in traffic]
        tr = [_req(Request, SamplingParams, t, w) for t, w in traffic]
        je.generate(jr)
        te.generate(tr)
        for a, b in zip(jr, tr):
            assert b.output_tokens == a.output_tokens
            assert b.finish_reason.value == a.finish_reason.value
        assert vars(te.media_stats) == vars(je.media_stats)
        if prefix_cache:
            assert vars(te.prefix_cache.stats) == vars(je.prefix_cache.stats)
        if layout == "paged":
            assert vars(te.pool.stats) == vars(je.pool.stats)
    ms = te.media_stats
    assert ms.encoder_invocations == 2 and ms.dedup_joins >= 1
    assert ms.embed_hits >= 1 and ms.xkv_hits >= 1
    assert (ms.xkv_lease_pages > 0) == (layout == "paged")
