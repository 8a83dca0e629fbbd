"""Vision serving of the port against the JAX package on the CPU, given the
same weights (bridged from one JAX init): the model's logits with images,
and the engine's greedy tokens and media counters for the same traffic —
cold, embedding-hit and cross-KV-hit requests, 8 concurrent requests with
one image, video frames streamed across encode waves, an abort of a pending
media request, and the content cache switched off — on the dense and the
paged layout, for ``qwen3-vl-toy`` and ``llama-3.2-vision-90b().reduced()``
(2 layers, one of them ``xattn``).

The reference initialises the cross-attention gates to 0, which makes a
fresh ``xattn`` layer an identity and the image invisible to the logits.
Every test here sets the gate leaves to 0.5 in the numpy tree both packages
receive, and checks that a different image changes the logits.

Tolerances: logits float32 atol 1e-4 (summation order; the logits are
O(1)); tokens and counters exact.  Both engines run with the same
arguments, speculative wave filling off (it changes no greedy token but
opens prefills, and so cross-KV lookups, early).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import content_cache as jcontent
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import build_model
from repro.models.model import init_cache as jax_init_cache
from repro.serving import media as jmedia
from repro_torch.configs import get_config
from repro_torch.core import content_cache
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import FinishReason, Request, SamplingParams
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import media
from torch_threads import one_torch_thread  # noqa: F401

CONFIGS = ("qwen3-vl-toy", "llama-3.2-vision-90b")
GATE = 0.5
ENGINE_KW = dict(max_batch=4, cache_len=128, prefill_chunk=32,
                 vision_work_iters=1, max_decode_block=1)


def _configs(name):
    jcfg, tcfg = jax_get_config(name), get_config(name)
    if name == "llama-3.2-vision-90b":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    return (dataclasses.replace(jcfg, dtype="float32"),
            dataclasses.replace(tcfg, dtype="float32"))


def _open_gates(tree):
    """Set every cross-attention gate leaf of a numpy params tree to GATE."""
    for layer in list(tree["prefix_layers"]) + list(tree["block"].values()):
        if "xgate_ffn" in layer:
            layer["xgate_ffn"] = np.full_like(layer["xgate_ffn"], GATE)
            layer["cross"]["xgate_attn"] = np.full_like(
                layer["cross"]["xgate_attn"], GATE)


@pytest.fixture(scope="module", params=CONFIGS)
def weights(request):
    jcfg, tcfg = _configs(request.param)
    tree = jax.tree.map(np.asarray,
                        build_model(jcfg).init(jax.random.PRNGKey(0)))
    _open_gates(tree)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, tcfg, "cpu"), tree)


def _image(seed, side=16):
    return np.random.default_rng(seed).integers(0, 256, (side, side, 3),
                                                dtype=np.uint8)


# --------------------------------------------------------------------------- #
# host media pipeline: bit-identical to the reference's
# --------------------------------------------------------------------------- #
def test_content_hash_and_encoder_bit_identical_to_reference():
    img = _image(1)
    for pixels in (img, img.astype(np.float32) / 255.0,
                   img.astype(np.uint16) * 3):
        assert content_cache.content_hash(pixels) == \
            jcontent.content_hash(pixels)
    hashes = [content_cache.content_hash(_image(s)) for s in range(3)]
    assert content_cache.media_set_digest(hashes) == \
        jcontent.media_set_digest(hashes)
    for pixels in (img, _image(2, side=70)):
        ours = media.VisionEncoderStub(64, 96, work_iters=2)(pixels)
        theirs = jmedia.VisionEncoderStub(64, 96, work_iters=2)(pixels)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    b64 = media.encode_b64(img)
    np.testing.assert_array_equal(media.decode_media(b64), img)
    assert media.encode_b64(img) == jmedia.encode_b64(img)


def test_synthetic_urls_live_in_the_ports_own_store():
    media.register_url("synthetic://port-only", _image(3))
    np.testing.assert_array_equal(
        media.decode_media({"url": "synthetic://port-only"}), _image(3))
    with pytest.raises(KeyError):
        jmedia.decode_media({"url": "synthetic://port-only"})


# --------------------------------------------------------------------------- #
# weights and logits
# --------------------------------------------------------------------------- #
def _xattn_layers(tree):
    """The cross-attention layers of a params or cache tree, prefix layers
    and stacked block positions alike."""
    return [sub for sub in (list(tree.get("prefix_layers",
                                          tree.get("prefix", [])))
                            + list((tree.get("block") or {}).values()))
            if "cross" in sub or "xk" in sub]


def test_bridge_carries_vision_proj_cross_subtree_and_gates(weights):
    jcfg, tcfg, _, tp, tree = weights
    assert tp["vision_proj"].shape == (jcfg.vision.embed_dim, jcfg.d_model)
    np.testing.assert_array_equal(tp["vision_proj"].numpy(),
                                  tree["vision_proj"])
    pairs = list(zip(_xattn_layers(tp), _xattn_layers(tree)))
    assert pairs
    for ours, theirs in pairs:
        assert set(ours["cross"]) == set(theirs["cross"]) == {
            "ln", "wq", "wk", "wv", "wo", "xgate_attn"}
        for name, leaf in theirs["cross"].items():
            np.testing.assert_array_equal(ours["cross"][name].numpy(), leaf)
        assert ours["xgate_ffn"].shape == theirs["xgate_ffn"].shape
        assert (ours["xgate_ffn"] == GATE).all()


def test_fresh_init_keeps_the_references_zero_gates():
    cfg = get_config("qwen3-vl-toy")
    params = model.Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    gates = _xattn_layers(params)
    assert gates and all(not g["xgate_ffn"].any()
                         and not g["cross"]["xgate_attn"].any()
                         for g in gates)
    assert params["vision_proj"].shape == (cfg.vision.embed_dim, cfg.d_model)


def _prefill_decode(apply, tokens, embeds, ctx_valid, cache, positions,
                    **kw):
    out = apply(tokens, mode="prefill", cache=cache, image_embeds=embeds,
                ctx_valid=ctx_valid, **kw)
    dec = apply(tokens[:, :1], mode="decode", positions=positions,
                cache=out.cache if out.cache is not None else cache,
                ctx_valid=ctx_valid)
    return out.logits, dec.logits


def test_prefill_and_decode_logits_with_images_match_reference(weights):
    jcfg, tcfg, jp, tp, _ = weights
    rng = np.random.default_rng(4)
    b, s, t = 2, 12, 2 * jcfg.vision.num_image_tokens
    toks = rng.integers(0, jcfg.vocab_size, (b, s))
    ctx_valid = np.ones((b, t), bool)
    ctx_valid[1, t // 2:] = False
    pos = np.full((b, 1), s)
    jm, tm = build_model(jcfg), model.Model(tcfg)

    def run(embeds):
        return _prefill_decode(
            lambda *a, **k: tm.apply(tp, *a, **k), torch.from_numpy(toks),
            torch.from_numpy(embeds), torch.from_numpy(ctx_valid),
            model.init_cache(tcfg, b, 32, ctx_len=t, device="cpu"),
            torch.from_numpy(pos))

    emb = rng.standard_normal((b, t, jcfg.vision.embed_dim)).astype(
        np.float32)
    first = run(emb)
    japply = jax.jit(jm.apply, static_argnames=("mode",))
    want = _prefill_decode(
        lambda *a, **k: japply(jp, *a, **k), jnp.asarray(toks),
        jnp.asarray(emb), jnp.asarray(ctx_valid),
        jax_init_cache(jcfg, b, 32, ctx_len=t), jnp.asarray(pos))
    for j, o in zip(want, first):
        np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=1e-4)
    other = run(emb[::-1].copy())
    for a, o in zip(first, other):
        assert (a - o).abs().max() > 1e-3        # the image reaches logits


def test_cross_cached_prefill_equals_fresh_prefill(weights):
    """The content-cache hit path (cross KV injected, context not projected)
    gives the fresh prefill's logits."""
    jcfg, tcfg, _, tp, _ = weights
    rng = np.random.default_rng(5)
    t = jcfg.vision.num_image_tokens
    toks = torch.from_numpy(rng.integers(0, jcfg.vocab_size, (1, 9)))
    emb = torch.from_numpy(rng.standard_normal(
        (1, t, jcfg.vision.embed_dim)).astype(np.float32))
    valid = torch.ones((1, t), dtype=torch.bool)
    tm = model.Model(tcfg)
    fresh = model.init_cache(tcfg, 1, 16, ctx_len=t, device="cpu")
    want = tm.apply(tp, toks, mode="prefill", cache=fresh, image_embeds=emb,
                    ctx_valid=valid).logits
    hit = model.init_cache(tcfg, 1, 16, ctx_len=t, device="cpu")
    for dst, src in zip(_xattn_layers(hit), _xattn_layers(fresh)):
        for name in ("xk", "xv"):
            dst[name].copy_(src[name])
    got = tm.apply(tp, toks, mode="prefill", cache=hit, cross_cached=True,
                   ctx_valid=valid).logits
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------- #
# engines: tokens and media counters for the same traffic
# --------------------------------------------------------------------------- #
def _traffic():
    """(prompt, images, video frames) per request of the first round: 8
    requests with one new image, two with distinct images, one 6-frame
    video (streamed over 3 encode waves of 4), and one (index 11) aborted
    while its encode is still pending."""
    rng = np.random.default_rng(7)
    viral = _image(10)
    out = []
    for i in range(12):
        prompt = [int(t) for t in rng.integers(1, 256, 6 + 3 * i)]
        if i < 8:
            out.append((prompt, [viral], []))
        elif i < 10:
            out.append((prompt, [_image(20 + i)], []))
        elif i == 10:
            out.append((prompt, [], [_image(40 + f, side=8)
                                     for f in range(6)]))
        else:
            out.append((prompt, [_image(60)], []))
    return out


def _second_round(first):
    """Warm requests: request 0 again (embedding and cross-KV hit), its
    image with a new second image (embedding hit, cross-KV miss), and the
    video again."""
    p0, imgs0, _ = first[0]
    return [(p0, imgs0, []), (first[1][0], imgs0 + first[8][1], []),
            first[10]]


def _serve(engine, make, rounds):
    """Add each round's requests, step once, abort request 11 of the first
    round (its encode still pending), then run; returns each round's
    requests."""
    done = []
    for r, traffic in enumerate(rounds):
        reqs = [make(p, i, v) for p, i, v in traffic]
        for req in reqs:
            engine.add_request(req)
        if r == 0:
            engine.step()
            assert engine.abort(reqs[11].request_id)
        engine.run()
        done.append(reqs)
    return done


def _engines(weights, **kw):
    jcfg, tcfg, jp, tp, _ = weights
    kw = {**ENGINE_KW, "speculative_fill": False, **kw}
    return (JaxEngine(jcfg, jp, **kw),
            InferenceEngine(tcfg, tp, device="cpu", **kw))


def _run_both(weights, **kw):
    je, te = _engines(weights, **kw)
    first = _traffic()
    rounds = [first, _second_round(first)]
    jr = _serve(je, lambda p, i, v: JaxRequest(
        prompt_tokens=p, images=i, video_frames=v,
        sampling=JaxSampling(max_tokens=4)), rounds)
    tr = _serve(te, lambda p, i, v: Request(
        prompt_tokens=p, images=i, video_frames=v,
        sampling=SamplingParams(max_tokens=4)), rounds)
    for jround, tround in zip(jr, tr):
        for a, b in zip(jround, tround):
            assert b.output_tokens == a.output_tokens
            assert b.finish_reason.value == a.finish_reason.value
            assert (b.vision_cache_hits, b.vision_cache_misses) == \
                (a.vision_cache_hits, a.vision_cache_misses)
    return je, te, tr


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_tokens_and_media_counters_match_reference(weights, layout):
    je, te, (first, second) = _run_both(weights, kv_layout=layout)
    stats = te.content_cache_stats()
    assert stats == je.content_cache_stats()
    assert first[11].finish_reason is FinishReason.ABORT
    # 8 identical images: one encoder call, the other 7 joined or hit
    viral = [r for r in first[:8]]
    assert sum(r.vision_cache_misses for r in viral) + \
        sum(r.vision_cache_hits for r in viral) == 8
    assert stats["dedup_joins"] + sum(r.vision_cache_hits for r in viral) \
        == 7
    assert stats["encode_waves"] >= 3 and stats["encode_queue_depth"] == 0
    # warm repeat: embedding and cross-KV hit, tokens equal to the cold run
    assert second[0].vision_cache_hits == 1
    assert second[0].output_tokens == first[0].output_tokens
    assert second[1].vision_cache_hits == 2      # embedding hits only
    assert stats["xkv_hits"] > 0 and stats["embed_hits"] >= 3
    if layout == "paged":
        assert stats["xkv_lease_pages"] > 0
        assert te.pool.stats.full_copies == 0


def test_engine_with_the_content_cache_off_matches_reference(weights):
    je, te, _ = _run_both(weights, enable_content_cache=False)
    stats = te.content_cache_stats()
    assert stats == je.content_cache_stats()
    assert not stats["enabled"] and stats["xkv_hits"] == 0
    # 7 joins in the first round, 1 in the second (two warm requests carry
    # the first round's image and nothing caches its embedding)
    assert stats["embed_hits"] == 0 and stats["dedup_joins"] == 8


def test_undecodable_media_fails_only_its_request():
    """An image URL nobody registered fails that request with an ERROR
    finish (as the reference's per-request boundary does); its neighbour
    with a good image is served."""
    engine = InferenceEngine(get_config("qwen3-vl-toy"), device="cpu",
                             **ENGINE_KW)
    bad = Request(prompt_tokens=[1, 2, 3], images=[{"url": "synthetic://none"}],
                  sampling=SamplingParams(max_tokens=2))
    good = Request(prompt_tokens=[4, 5, 6], images=[_image(70)],
                   sampling=SamplingParams(max_tokens=2))
    engine.generate([bad, good])
    assert bad.finish_reason is FinishReason.ERROR and "media" in bad.error
    assert good.finish_reason is FinishReason.LENGTH
    assert len(good.output_tokens) == 2
    assert engine.scheduler.stats.failed == 1
    assert engine.content_cache_stats()["encoder_invocations"] == 1


def test_paged_pool_keeps_cross_kv_dense_per_slot():
    """Under the paged layout the cross-attention leaves stay dense per
    slot: admitted rows land in their slots and read back unchanged, and
    they take no page of the arena."""
    from repro_torch.core.paged_kv import PagedKVPool
    cfg = get_config("qwen3-vl-toy")
    ctx = cfg.vision.num_image_tokens
    pool = PagedKVPool(cfg, 2, 64, ctx_len=ctx, page_size=16, device="cpu")
    rows = []
    for seed in (1, 2):
        row = model.init_cache(cfg, 1, 64, ctx_len=ctx, device="cpu")
        for leaf in model.tree_leaves(row):
            leaf.normal_(generator=torch.Generator().manual_seed(seed))
        rows.append(row)
    slots = [pool.allocate(), pool.allocate()]
    pool.insert_many(slots, rows, consumed=[40, 20])
    assert sum(len(pool.slot_pages(s)) for s in slots) == 3 + 2
    for slot, row, n in zip(slots, rows, (40, 20)):
        got = pool.read(slot)
        for dst, src in zip(_xattn_layers(got), _xattn_layers(row)):
            for name in ("xk", "xv"):
                torch.testing.assert_close(dst[name], src[name], atol=0,
                                           rtol=0)
        for pos, sub in row["block"].items():
            if "k" in sub:
                torch.testing.assert_close(got["block"][pos]["k"][:, :, :n],
                                           sub["k"][:, :, :n], atol=0,
                                           rtol=0)


def test_chaos_survivors_bit_identical_with_content_cache(weights):
    """``tests/test_mllm_serving.py``'s chaos test: under injected decode
    faults (one seed for both engines) the port fails the same requests as
    the JAX engine, and the surviving image requests keep the tokens of a
    fault-free run (equal to the JAX engine's); the content cache and the
    encode waves never leak one request's failure into a neighbour, and
    the failed requests' media jobs leave the tables."""
    from repro.core.faults import FaultInjector as JaxFaultInjector
    from repro_torch.core.faults import FaultInjector
    shared = _image(41)

    def traffic():
        rng = np.random.default_rng(3)
        return [([int(t) for t in rng.integers(1, 256, 8 + 2 * i)],
                 [shared if i % 2 == 0 else _image(500 + i)], 940_000 + i)
                for i in range(6)]

    def run(engine, make):
        return engine.generate([make(p, imgs, rid)
                                for p, imgs, rid in traffic()])

    def jax_req(p, imgs, rid):
        return JaxRequest(prompt_tokens=p, images=imgs, request_id=rid,
                          sampling=JaxSampling(max_tokens=6))

    def port_req(p, imgs, rid):
        return Request(prompt_tokens=p, images=imgs, request_id=rid,
                       sampling=SamplingParams(max_tokens=6))

    kw = dict(max_batch=4, cache_len=128, vision_work_iters=1)
    jclean, tclean = _engines(weights, **kw)
    baseline = {r.request_id: list(r.output_tokens)
                for r in run(tclean, port_req)}
    assert all(baseline.values())
    assert baseline == {r.request_id: list(r.output_tokens)
                        for r in run(jclean, jax_req)}
    jchaos, tchaos = _engines(weights, **kw)
    jchaos.faults = JaxFaultInjector(seed=3, rates={"decode": 0.25})
    tchaos.faults = FaultInjector(seed=3, rates={"decode": 0.25})
    out = run(tchaos, port_req)
    failed = {r.request_id for r in out
              if r.finish_reason is FinishReason.ERROR}
    survivors = [r for r in out if r.finish_reason in (FinishReason.STOP,
                                                       FinishReason.LENGTH)]
    assert failed and survivors
    assert failed == {r.request_id for r in run(jchaos, jax_req)
                      if r.finish_reason.value == "error"}
    for r in survivors:
        assert r.output_tokens == baseline[r.request_id]
    assert not tchaos._encode_tasks and not tchaos._media_jobs
