"""The port's MoE against the JAX package on the CPU: ``apply_moe`` with
capacity routing, ``Model.apply`` logits of MoE models (``deepseek-moe-16b``
with a dense first layer, ``grok-1-314b``; both reduced), the weight
bridge's float32 router, and the engine's greedy tokens
on ``qwen3-30b-a3b-toy`` (capacity factor 1.25, so prefill waves drop
pairs) over the dense ring and the paged arena.

Inputs come from numpy seeds and weights from one JAX ``Model.init``,
bridged with ``params_from_jax``; float32 throughout.  Tolerances: the MoE
block's output atol 1e-5 and its load-balance loss atol 1e-6 (the same
float32 sums in another order); logits atol 1e-4, as
``tests/test_torch_model.py``; greedy tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import Request, SamplingParams
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

ATOL = dict(atol=1e-4, rtol=1e-4)
DEEPSEEK = "deepseek-moe-16b"


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
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32),
                               **(tol or ATOL))


def _pair(jcfg, tcfg):
    jp = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


# the MoE configs held to the reference reduced: deepseek at 4 layers (a
# dense prefix layer at ``dense_d_ff`` 256, not ``d_ff`` 512, then 3
# stacked MoE layers of 4 experts, top-2, one shared expert), grok at 2
# (every layer MoE, no shared expert, G 4); no-drop
MOE_MODELS = {DEEPSEEK: dict(num_layers=4), "grok-1-314b": {}}


def _reduced_pair(name):
    jcfg = jax_get_config(name).reduced(**MOE_MODELS[name])
    tcfg = get_config(name).reduced(**MOE_MODELS[name])
    return (jcfg, tcfg, *_pair(jcfg, tcfg))


@pytest.fixture(scope="module")
def deepseek4():
    return _reduced_pair(DEEPSEEK)


@pytest.fixture(scope="module", params=sorted(MOE_MODELS))
def moe_model(request, deepseek4):
    return deepseek4 if request.param == DEEPSEEK else \
        _reduced_pair(request.param)


# --------------------------------------------------------------------------- #
# apply_moe
# --------------------------------------------------------------------------- #
def _reference_drops(p, x, cfg, seq_valid):
    """Pairs of live tokens past their expert's capacity, from the
    reference's own routing intermediates."""
    m = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, m.num_experts, m.experts_per_token
    cap = max(8, int(np.ceil(t * k / e * m.capacity_factor)))
    flat = jlayers.rmsnorm(x, p["ln"], cfg.rms_eps).reshape(t, d)
    probs = jax.nn.softmax(flat.astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    live = jnp.repeat(seq_valid.reshape(t), k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t * k, e)
    onehot = onehot * live[:, None]
    rank = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return int(jnp.sum((rank >= cap) & live))


@pytest.mark.parametrize("case", ["no_drop", "capacity_1.25"])
def test_apply_moe_matches_reference(deepseek4, case):
    """The MoE block of the first stacked layer: (i) no-drop, (ii) the
    published capacity factor with right-padded rows, on tokens that share
    a common direction (as hidden states do), so routing is skewed and at
    least one pair is dropped."""
    jcfg, tcfg, jp, tp = deepseek4
    kw = {}
    rng = np.random.default_rng(7)
    if case == "no_drop":
        b, s = 2, 12
        x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    else:
        moe = dataclasses.replace(jcfg.moe, capacity_factor=1.25)
        jcfg = dataclasses.replace(jcfg, moe=moe)
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=1.25))
        b, s = 3, 40
        common = 2.0 * rng.standard_normal(jcfg.d_model)
        x = (common + rng.standard_normal((b, s, jcfg.d_model))
             ).astype(np.float32)
        sv = np.arange(s)[None] < np.array([[s], [33], [21]])
        kw = dict(seq_valid=sv)
    jmoe = jax.tree.map(lambda a: a[0], jp["block"]["pos0"]["moe"])
    tmoe = model.tree_map(lambda a: a[0], tp["block"]["pos0"]["moe"])
    jy, jaux = jlayers.apply_moe(jmoe, x, jcfg, **kw)
    ty, taux = layers.apply_moe(tmoe, torch.from_numpy(x), tcfg,
                                **{k: torch.from_numpy(v)
                                   for k, v in kw.items()})
    _close(ty, jy, atol=1e-5, rtol=0)
    assert taux.item() == pytest.approx(float(jaux), abs=1e-6)
    if case != "no_drop":
        assert _reference_drops(jmoe, x, jcfg, sv) > 0
        cap = layers.moe_capacity(tcfg, b * s)
        assert cap == max(8, int(np.ceil(b * s * 2 / 4 * 1.25)))


def test_moe_capacity_matches_the_reference_expression():
    """``cap`` over the static call shape, in Python arithmetic: no-drop,
    the floor of 8, and deepseek's prefill and decode calls."""
    cfg = get_config(DEEPSEEK)
    for t in (1, 8, 48, 4096, 4095):
        want = max(8, int(np.ceil(t * 6 / 64 * 1.25)))
        assert layers.moe_capacity(cfg, t) == want
    assert layers.moe_capacity(cfg.reduced(), 10) == 10 * 2


# --------------------------------------------------------------------------- #
# the model: shapes, bridge, logits
# --------------------------------------------------------------------------- #
def test_moe_params_match_reference_shapes(moe_model):
    """The port's init and the bridged tree have the reference's
    ``init_shapes()``: deepseek's prefix layer's MLP at ``dense_d_ff``,
    the MoE leaves under ``moe`` instead of ``ffn``."""
    jcfg, tcfg, _, tp = moe_model
    assert model.find_pattern(tcfg.layer_kinds()) == \
        jmodel.find_pattern(jcfg.layer_kinds())
    shapes = dict(_leaves(jmodel.build_model(jcfg).init_shapes()))
    ours = dict(_leaves(model.Model(tcfg).init(
        torch.Generator().manual_seed(0), "cpu")))
    for tree in (ours, dict(_leaves(tp))):
        assert tree.keys() == shapes.keys()
        for key, sds in shapes.items():
            assert tuple(tree[key].shape) == sds.shape, key
    assert not any("ffn" in key for key in ours if "/block/" in key)
    if tcfg.name.startswith(DEEPSEEK):
        assert model.find_pattern(tcfg.layer_kinds()) == (("attn",),
                                                          ("moe",), 3)
        assert ours["/prefix_layers[0]/ffn/w_up"].shape[1] == 256


def test_bridge_keeps_the_router_in_float32():
    """A bf16 MoE model through the bridge and through the port's own init:
    the same dtype leaf by leaf (the router float32, the rest bf16)."""
    jcfg = dataclasses.replace(jax_get_config(DEEPSEEK).reduced(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(DEEPSEEK).reduced(),
                               dtype="bfloat16")
    _, bridged = _pair(jcfg, tcfg)
    ours = dict(_leaves(model.Model(tcfg).init(
        torch.Generator().manual_seed(0), "cpu")))
    bridged = dict(_leaves(bridged))
    assert bridged.keys() == ours.keys()
    for key, leaf in ours.items():
        assert bridged[key].dtype == leaf.dtype, key
    routers = [k for k in ours if k.endswith("/moe/router")]
    assert routers and all(ours[k].dtype == torch.float32 for k in routers)
    assert all(ours[k].dtype == torch.bfloat16 for k in ours
               if k.endswith("/moe/we_up"))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_model_logits_match_reference(moe_model, mode):
    """Train logits; prefill logits and cache; a ragged resume-prefill then
    three decode steps, logits and caches compared at every call."""
    jcfg, tcfg, jp, tp = moe_model
    jm, tm = jmodel.build_model(jcfg), model.Model(tcfg)
    rng = np.random.default_rng(3)
    b, s, cache_len = 2, 16, 40
    toks = rng.integers(0, jcfg.vocab_size, (b, s))
    if mode == "train":
        _close(tm.apply(tp, torch.from_numpy(toks), mode="train").logits,
               jm.apply(jp, toks, mode="train").logits)
        return
    jc = jmodel.init_cache(jcfg, b, cache_len)
    tc = model.init_cache(tcfg, b, cache_len, device="cpu")
    if mode == "prefill":
        jout = jm.apply(jp, toks, mode="prefill", cache=jc)
        tout = tm.apply(tp, torch.from_numpy(toks), mode="prefill", cache=tc)
        _close(tout.logits, jout.logits)
        for (key, a), (_, t) in zip(_leaves(jout.cache), _leaves(tc)):
            _close(t, a, atol=1e-5, rtol=0)
        return
    lengths = np.array([s, 9])
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    sv = pos < lengths[:, None]
    jout = jm.apply(jp, toks, mode="prefill", positions=pos, cache=jc,
                    resume=True, seq_valid=sv)
    jc = jout.cache
    tout = tm.apply(tp, torch.from_numpy(toks), mode="prefill",
                    positions=torch.from_numpy(pos), cache=tc, resume=True,
                    seq_valid=torch.from_numpy(sv))
    _close(tout.logits, jout.logits)
    nxt = np.asarray(jout.logits)[np.arange(b), lengths - 1].argmax(-1)
    pos = lengths.copy()
    for _ in range(3):
        jout = jm.apply(jp, nxt[:, None], mode="decode",
                        positions=pos[:, None], cache=jc)
        jc = jout.cache
        tout = tm.apply(tp, torch.from_numpy(nxt[:, None]), mode="decode",
                        positions=torch.from_numpy(pos[:, None]), cache=tc)
        _close(tout.logits, jout.logits)
        nxt, pos = np.asarray(jout.logits)[:, 0].argmax(-1), pos + 1
    for (key, a), (_, t) in zip(_leaves(jc), _leaves(tc)):
        _close(t, a, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def qwen3_moe():
    jcfg = jax_get_config("qwen3-30b-a3b-toy")
    tcfg = get_config("qwen3-30b-a3b-toy")
    assert tcfg.moe.capacity_factor == 1.25
    return (jcfg, tcfg, *_pair(jcfg, tcfg))


def _prompts():
    """Five prompts: three share a 40-token prefix (the prefix cache's
    case), one repeats a single token (its tokens route alike, so its wave
    overflows an expert), one is short."""
    rng = np.random.default_rng(0)
    base = [int(t) for t in rng.integers(1, 256, size=40)]
    return ([base + [int(t) for t in rng.integers(1, 256, size=n)]
             for n in (5, 9, 30)]
            + [[97] * 36, [int(t) for t in rng.integers(1, 256, size=3)]])


class _DropCounter:
    """Wraps ``layers.apply_moe``: pairs of live tokens that the port's
    routing sends to the trash slot, over every call with ``seq_valid``
    (the prefill waves)."""

    def __init__(self, monkeypatch):
        self.dropped = 0
        inner = layers.apply_moe

        def counted(p, x, cfg, seq_valid=None):
            if seq_valid is not None:
                flat = layers.rmsnorm(x, p["ln"], cfg.rms_eps).reshape(
                    -1, x.shape[-1])
                _, slot, cap, _ = layers.moe_route(p, flat, cfg,
                                                   seq_valid.reshape(-1))
                live = int(seq_valid.sum()) * cfg.moe.experts_per_token
                kept = int((slot != cfg.moe.num_experts * cap).sum())
                self.dropped += live - kept
            return inner(p, x, cfg, seq_valid=seq_valid)

        monkeypatch.setattr(layers, "apply_moe", counted)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("prefill_chunk", [0, 32])
def test_moe_engine_greedy_tokens_match_reference(qwen3_moe, layout,
                                                  prefill_chunk, monkeypatch):
    """5 requests on 2 slots with the prefix cache on: the same greedy
    tokens, finish reasons and prefix hits as the JAX engine, while the
    port's prefill waves drop pairs past capacity."""
    jcfg, tcfg, jp, tp = qwen3_moe
    kw = dict(max_batch=2, cache_len=128, prefill_chunk=prefill_chunk,
              kv_layout=layout)
    if layout == "paged":
        kw["kv_page_size"] = 16
    sampling = [{"max_tokens": m} for m in (12, 7, 10, 16, 5)]
    jr = [JaxRequest(prompt_tokens=p, sampling=JaxSampling(**s))
          for p, s in zip(_prompts(), sampling)]
    tr = [Request(prompt_tokens=p, sampling=SamplingParams(**s))
          for p, s in zip(_prompts(), sampling)]
    kw["speculative_fill"] = False
    JaxEngine(jcfg, jp, **kw).generate(jr)
    drops = _DropCounter(monkeypatch)
    InferenceEngine(tcfg, tp, device="cpu", **kw).generate(tr)
    for a, b in zip(jr, tr):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason.value == a.finish_reason.value
        assert b.cached_prefix_len == a.cached_prefix_len
    if layout == "paged" or prefill_chunk:
        # the dense ring with monolithic prefill publishes a prompt only
        # at retire: neither engine hits there with these five requests
        assert any(r.cached_prefix_len for r in tr)
    assert drops.dropped > 0
