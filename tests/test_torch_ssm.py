"""The port's Mamba-2 path against the JAX package on the CPU: the chunked
SSD scan against the reference's ``ops.ssd`` and its sequential oracle
``ref.ssd_ref``, the decode step, the causal conv with per-row lengths, the
Mamba block in prefill, resume and decode with right-padding, a frozen
slot's recurrent leaves, the weight bridge's float32 SSM leaves in a bf16
model, and ``Model.apply`` logits of ``mamba2-780m`` and
``jamba-1.5-large-398b`` (both reduced: 2 Mamba layers; one group of 8
layers with one attention layer and 4 MoE blocks).

Inputs come from numpy seeds, weights from one JAX ``Model.init`` bridged
with ``params_from_jax``; float32 throughout.  Tolerances: the SSD scan and
the Mamba block 1e-5, absolute and relative (the same float32 products
summed in another order: inputs are scaled so that outputs are O(1));
logits atol 1e-4, as ``tests/test_torch_model.py``; a frozen slot exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)
SSM_MODELS = ("mamba2-780m", "jamba-1.5-large-398b")


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
                               np.asarray(j, np.float32), **(tol or TOL))


def _jit_apply(jm):
    """The reference model's ``apply`` under one ``jax.jit`` per mode (a
    whole-graph compile: much quicker on the CPU than op-by-op eager)."""
    return jax.jit(jm.apply, static_argnames=("mode", "resume"))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module", params=SSM_MODELS)
def ssm_pair(request):
    """(jax cfg, torch cfg, jax params, torch params), reduced, float32."""
    jcfg = jax_get_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


# --------------------------------------------------------------------------- #
# the SSD math
# --------------------------------------------------------------------------- #
def _ssd_inputs(seed, b, s, h, p, g, n, with_init):
    """SSD inputs at the scale the block feeds it (dt a softplus of small
    values, x, B, C of unit scale over sqrt(N))."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(f32)
    a = -np.exp(rng.uniform(0.0, 2.0, h)).astype(f32)
    bm = (rng.standard_normal((b, s, g, n)) / np.sqrt(n)).astype(f32)
    cm = (rng.standard_normal((b, s, g, n)) / np.sqrt(n)).astype(f32)
    init = (rng.standard_normal((b, h, p, n)).astype(f32) if with_init
            else None)
    return x, dt, a, bm, cm, init


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("s,chunk,g", [(1, 32, 1), (37, 32, 2), (64, 32, 1),
                                       (300, 64, 2), (300, 32, 1)])
def test_ssd_matches_reference_and_oracle(s, chunk, g, with_init):
    """``ops.ssd`` (chunked; a ragged tail padded with dt = 0) against the
    JAX ``ops.ssd`` and the sequential ``ref.ssd_ref``; the port's own
    ``ref.ssd_ref`` against the JAX oracle too."""
    x, dt, a, bm, cm, init = _ssd_inputs(s, 2, s, 4, 8, g, 16, with_init)
    jy, js = jax.jit(jops.ssd, static_argnames="chunk")(
        x, dt, a, bm, cm, chunk=chunk, init_state=init)
    ry, rs = jax.jit(jref.ssd_ref)(x, dt, a, bm, cm, init_state=init)
    tx, tdt, ta, tb, tc, ti = _t(x, dt, a, bm, cm, init)
    y, state = ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, init_state=ti)
    assert y.shape == x.shape and y.is_contiguous()
    assert state.dtype == torch.float32
    for want_y, want_s in ((jy, js), (ry, rs)):
        _close(y, want_y)
        _close(state, want_s)
    oy, os_ = ref.ssd_ref(tx, tdt, ta, tb, tc, init_state=ti)
    _close(oy, ry)
    _close(os_, rs)


def test_ssd_padded_steps_leave_the_state():
    """dt = 0 steps (right-padding) are identity updates: the state after
    a padded sequence equals the state after its valid prefix."""
    x, dt, a, bm, cm, init = _ssd_inputs(5, 1, 50, 4, 8, 1, 16, True)
    dt[:, 33:] = 0.0
    tx, tdt, ta, tb, tc, ti = _t(x, dt, a, bm, cm, init)
    _, full = ops.ssd(tx, tdt, ta, tb, tc, chunk=32, init_state=ti)
    _, valid = ops.ssd(tx[:, :33], tdt[:, :33], ta, tb[:, :33], tc[:, :33],
                       chunk=32, init_state=ti)
    _close(full, valid, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    x, dt, a, bm, cm, init = _ssd_inputs(9, 3, 1, 4, 8, g, 16, True)
    jy, js = jops.ssd_decode_step(x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0],
                                  init)
    tx, tdt, ta, tb, tc, ti = _t(x, dt, a, bm, cm, init)
    y, state = ops.ssd_decode_step(tx[:, 0], tdt[:, 0], ta, tb[:, 0],
                                   tc[:, 0], ti)
    _close(y, jy)
    _close(state, js)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_with_lengths_matches_reference(with_state):
    """Outputs and the carried window: the physical tail, and each row's
    window ending at its own last valid input (``lengths``)."""
    rng = np.random.default_rng(11)
    b, s, c, w = 3, 10, 12, 4
    xbc = rng.standard_normal((b, s, c)).astype(np.float32)
    wt = rng.standard_normal((w, c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    st = (rng.standard_normal((b, w - 1, c)).astype(np.float32)
          if with_state else None)
    lengths = np.array([10, 4, 0], np.int32)
    for ln in (None, lengths):
        jo, jst = jlayers._causal_conv(xbc, wt, bias, st, lengths=ln)
        to, tst = layers._causal_conv(*_t(xbc, wt, bias, st),
                                      lengths=None if ln is None
                                      else torch.from_numpy(ln))
        _close(to, jo, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


# --------------------------------------------------------------------------- #
# the Mamba block
# --------------------------------------------------------------------------- #
def _ssm_params(jcfg, tcfg):
    """One Mamba block's params: the reference's init, bridged."""
    jp = jlayers.init_ssm(jax.random.PRNGKey(3), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(jp, tcfg, "cpu")


def _mamba_cfgs():
    return (jax_get_config("mamba2-780m").reduced(),
            get_config("mamba2-780m").reduced())


def test_apply_ssm_prefill_resume_decode_match_reference():
    """A fresh prefill of right-padded rows, a resume prefill from its
    cache, then 3 decode steps: outputs and the ``conv``/``state`` leaves
    at every call (the port writes them in place)."""
    jcfg, tcfg = _mamba_cfgs()
    jp, tp = _ssm_params(jcfg, tcfg)
    rng = np.random.default_rng(2)
    b, s = 3, 20
    shapes = model.init_cache(tcfg, b, 8, device="cpu")["block"]["pos0"]
    tc = {k: v[0].clone() for k, v in shapes.items()}
    jc = {k: np.asarray(v.numpy()) for k, v in tc.items()}
    sv = np.arange(s)[None] < np.array([[20], [13], [1]])
    japply = jax.jit(lambda p, x, c, mode, resume=False, seq_valid=None:
                     jlayers.apply_ssm(p, x, cfg=jcfg, mode=mode, cache=c,
                                       resume=resume, seq_valid=seq_valid),
                     static_argnames=("mode", "resume"))
    for resume in (False, True):
        x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
        jy, jc = japply(jp, x, jc, mode="prefill", resume=resume,
                        seq_valid=sv)
        ty, out = layers.apply_ssm(tp, torch.from_numpy(x), cfg=tcfg,
                                   mode="prefill", cache=tc, resume=resume,
                                   seq_valid=torch.from_numpy(sv))
        assert out is tc
        _close(ty, jy)
        for name in ("conv", "state"):
            _close(tc[name], jc[name])
    for _ in range(3):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = japply(jp, x, jc, mode="decode")
        ty, _ = layers.apply_ssm(tp, torch.from_numpy(x), cfg=tcfg,
                                 mode="decode", cache=tc)
        _close(ty, jy)
        for name in ("conv", "state"):
            _close(tc[name], jc[name])
    assert tc["state"].dtype == torch.float32


def test_fresh_prefill_reads_no_cached_state():
    """``resume=False`` ignores what the cache holds, as the reference."""
    jcfg, tcfg = _mamba_cfgs()
    _, tp = _ssm_params(jcfg, tcfg)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 6, tcfg.d_model)).astype(np.float32))
    outs = []
    for fill in (0.0, 3.0):
        c = model.init_cache(tcfg, 1, 8, device="cpu")["block"]["pos0"]
        c = {k: v[0].fill_(fill) for k, v in c.items()}
        outs.append(layers.apply_ssm(tp, x, cfg=tcfg, mode="prefill",
                                     cache=c)[0])
    assert torch.equal(outs[0], outs[1])


def test_frozen_slot_keeps_conv_and_state_bit_for_bit(ssm_pair):
    """Decode with ``slot_active`` False on slot 1: every ``conv``/``state``
    leaf of that slot is unchanged bit for bit, slot 0's moves."""
    _, tcfg, _, tp = ssm_pair
    tm = model.Model(tcfg)
    tc = model.init_cache(tcfg, 2, 16, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for leaf in model.tree_leaves(tc):
        leaf.normal_(generator=gen)
    before = model.tree_map(torch.clone, tc)
    tm.apply(tp, torch.tensor([[3], [4]]), mode="decode",
             positions=torch.tensor([[5], [6]]), cache=tc,
             slot_active=torch.tensor([True, False]))
    checked = 0
    for (key, a), (_, b) in zip(_leaves(before), _leaves(tc)):
        if key.rsplit("/", 1)[-1] not in ("conv", "state"):
            continue
        row = 1 if key.startswith("/block") else None
        a1 = a[:, 1] if row else a[1]
        b1 = b[:, 1] if row else b[1]
        assert torch.equal(a1, b1), key
        a0 = a[:, 0] if row else a[0]
        b0 = b[:, 0] if row else b[0]
        assert not torch.equal(a0, b0), key
        checked += 1
    assert checked >= 2


def test_bridge_keeps_the_ssm_leaves_in_float32():
    """A bf16 jamba through the bridge and through the port's own init:
    the same dtype leaf by leaf; ``a_log``, ``d_skip``, ``dt_bias`` and
    the router float32, the rest bf16; the bridged float32 leaves equal
    the reference's bit for bit."""
    name = "jamba-1.5-large-398b"
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    jp = jax.tree.map(np.asarray,
                      jmodel.build_model(jcfg).init(jax.random.PRNGKey(0)))
    bridged = dict(_leaves(params_from_jax(jp, tcfg, "cpu")))
    ours = dict(_leaves(model.Model(tcfg).init(
        torch.Generator().manual_seed(0), "cpu")))
    assert bridged.keys() == ours.keys() == dict(_leaves(jp)).keys()
    for key, leaf in ours.items():
        assert bridged[key].dtype == leaf.dtype, key
    f32 = {k for k, v in ours.items() if v.dtype == torch.float32}
    assert f32 and all(k.rsplit("/", 1)[-1] in
                       ("a_log", "d_skip", "dt_bias", "router") for k in f32)
    assert {k.rsplit("/", 1)[-1] for k in f32} == {"a_log", "d_skip",
                                                   "dt_bias", "router"}
    src = dict(_leaves(jp))
    for k in f32:
        np.testing.assert_array_equal(bridged[k].numpy(), src[k])


# --------------------------------------------------------------------------- #
# the model: shapes, caches, logits
# --------------------------------------------------------------------------- #
def test_ssm_params_and_caches_match_reference_shapes(ssm_pair):
    jcfg, tcfg, _, tp = ssm_pair
    shapes = dict(_leaves(jmodel.build_model(jcfg).init_shapes()))
    ours = dict(_leaves(model.Model(tcfg).init(
        torch.Generator().manual_seed(0), "cpu")))
    for tree in (ours, dict(_leaves(tp))):
        assert tree.keys() == shapes.keys()
        for key, sds in shapes.items():
            assert tuple(tree[key].shape) == sds.shape, key
    jc = dict(_leaves(jmodel.init_cache(jcfg, 2, 24)))
    tc = dict(_leaves(model.init_cache(tcfg, 2, 24, device="cpu")))
    assert tc.keys() == jc.keys()
    for key, leaf in jc.items():
        assert tuple(tc[key].shape) == leaf.shape, key
        assert str(tc[key].dtype)[6:] == str(leaf.dtype), key


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_model_logits_match_reference(ssm_pair, mode):
    """Train logits; prefill logits and cache; a ragged resume-prefill in
    two chunks then three decode steps, logits and caches at every call."""
    jcfg, tcfg, jp, tp = ssm_pair
    jm, tm = jmodel.build_model(jcfg), model.Model(tcfg)
    japply = _jit_apply(jm)
    rng = np.random.default_rng(3)
    b, s, cache_len = 2, 40, 64
    toks = rng.integers(0, jcfg.vocab_size, (b, s))
    if mode == "train":
        _close(tm.apply(tp, torch.from_numpy(toks), mode="train").logits,
               japply(jp, toks, mode="train").logits, **LOGITS)
        return
    jc = jmodel.init_cache(jcfg, b, cache_len)
    tc = model.init_cache(tcfg, b, cache_len, device="cpu")
    if mode == "prefill":
        jout = japply(jp, toks, mode="prefill", cache=jc)
        tout = tm.apply(tp, torch.from_numpy(toks), mode="prefill", cache=tc)
        _close(tout.logits, jout.logits, **LOGITS)
        for (key, a), (_, t) in zip(_leaves(jout.cache), _leaves(tc)):
            _close(t, a, **LOGITS)
        return
    lengths = np.array([s, 29])
    chunk = 24
    for lo in (0, chunk):
        seg = toks[:, lo:lo + chunk]
        pos = np.broadcast_to(np.arange(lo, lo + seg.shape[1]),
                              seg.shape).copy()
        sv = pos < lengths[:, None]
        jout = japply(jp, seg, mode="prefill", positions=pos, cache=jc,
                      resume=True, seq_valid=sv)
        jc = jout.cache
        tout = tm.apply(tp, torch.from_numpy(seg), mode="prefill",
                        positions=torch.from_numpy(pos), cache=tc,
                        resume=True, seq_valid=torch.from_numpy(sv))
        _close(tout.logits, jout.logits, **LOGITS)
    last = np.asarray(jout.logits)[np.arange(b), lengths - chunk - 1]
    nxt, pos = last.argmax(-1), lengths.copy()
    for _ in range(3):
        jout = japply(jp, nxt[:, None], mode="decode",
                      positions=pos[:, None], cache=jc)
        jc = jout.cache
        tout = tm.apply(tp, torch.from_numpy(nxt[:, None]), mode="decode",
                        positions=torch.from_numpy(pos[:, None]), cache=tc)
        _close(tout.logits, jout.logits, **LOGITS)
        nxt, pos = np.asarray(jout.logits)[:, 0].argmax(-1), pos + 1
    for (key, a), (_, t) in zip(_leaves(jc), _leaves(tc)):
        _close(t, a, **LOGITS)
