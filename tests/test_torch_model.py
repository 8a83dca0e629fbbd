"""The port's model stack against the JAX package on the CPU: the weight
bridge, the layer primitives, the attention layer in each ported mode, and
``Model.apply`` logits (train, prefill, resume-prefill with ``seq_valid``,
decode) on ``qwen2-0.5b`` reduced (qkv bias, tied embeddings, G = 4) and
``qwen3-0.6b-toy``, in float32, and the paged decode branch over a page
arena, fp and int8.  Tolerance atol 1e-4: the same float32 arithmetic
summed in another order.  Also the port's import rules.
"""
import dataclasses
import re
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import AudioConfig, get_config, registry
from repro_torch.core.kv_cache import SlotKVPool, init_decode_state
from repro_torch.core.paged_kv import PagedKVPool
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax

ATOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen2-0.5b-reduced", "qwen3-0.6b-toy"]
PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _cfgs(arch):
    if arch.endswith("-reduced"):
        name = arch[:-len("-reduced")]
        return jax_get_config(name).reduced(), get_config(name).reduced()
    return jax_get_config(arch), get_config(arch)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, torch cfg, jax params, torch params) from one JAX init."""
    jcfg, tcfg = _cfgs(request.param)
    jp = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


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


# --------------------------------------------------------------------------- #
# configs, pattern, bridge, init
# --------------------------------------------------------------------------- #
def test_config_registry_copies_the_reference():
    ours = registry()
    for name in ("qwen2-0.5b", "qwen3-0.6b-toy"):
        assert asdict(ours[name]) == asdict(jax_get_config(name))
        assert asdict(ours[name].reduced()) == \
            asdict(jax_get_config(name).reduced())


def test_find_pattern_matches_reference():
    for cfg in registry().values():
        kinds = cfg.layer_kinds()
        assert model.find_pattern(kinds) == jmodel.find_pattern(kinds)


def test_bridge_copies_every_leaf(pair):
    _, _, jp, tp = pair
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for key, leaf in jl.items():
        assert tuple(tl[key].shape) == leaf.shape, key
        np.testing.assert_array_equal(tl[key].numpy(), np.asarray(leaf),
                                      err_msg=key)


def test_init_matches_reference_shapes_and_scale(pair):
    jcfg, tcfg, jp, _ = pair
    ours = model.Model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(ours))
    assert jl.keys() == tl.keys()
    for key, leaf in jl.items():
        assert tuple(tl[key].shape) == leaf.shape, key
        assert tl[key].dtype == torch.float32
        a, b = np.asarray(leaf), tl[key].numpy()
        if a.size > 1000:          # same std 1/sqrt(fan_in), other draws
            assert b.std() == pytest.approx(a.std(), rel=0.1), key


def test_init_cache_matches_reference(pair):
    jcfg, tcfg, _, _ = pair
    jc = jmodel.init_cache(jcfg, 3, 40)
    tc = model.init_cache(tcfg, 3, 40, device="cpu")
    jl, tl = dict(_leaves(jc)), dict(_leaves(tc))
    assert jl.keys() == tl.keys()
    for key, leaf in jl.items():
        assert tuple(tl[key].shape) == leaf.shape and not tl[key].any()


# --------------------------------------------------------------------------- #
# primitives and the attention layer
# --------------------------------------------------------------------------- #
def test_primitives_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(x, pos, 1e6))
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    _close(layers.rmsnorm(torch.from_numpy(h), torch.from_numpy(w), 1e-6),
           jlayers.rmsnorm(h, w, 1e-6))
    mlp = {k: rng.standard_normal(s).astype(np.float32) / 8 for k, s in
           (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    _close(layers.apply_mlp({k: torch.from_numpy(v) for k, v in mlp.items()},
                            torch.from_numpy(h)), jlayers.apply_mlp(mlp, h))


@pytest.mark.parametrize("mode", ["train", "prefill", "resume", "decode"])
def test_attention_layer_modes_match_reference(pair, mode):
    jcfg, tcfg, jp, tp = pair
    jblock = jax.tree.map(lambda a: a[0], jp["block"]["pos0"]["attn"])
    tblock = model.tree_map(lambda a: a[0], tp["block"]["pos0"]["attn"])
    rng = np.random.default_rng(1)
    b, s, sc = 2, 1 if mode == "decode" else 12, 32
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((b, sc, jcfg.num_kv_heads, jcfg.head_dim)
                                    ).astype(np.float32) for n in ("k", "v")}
    kw, tkw = {}, {}
    if mode == "decode":
        pos = np.array([[5], [40]])                   # row 1 has wrapped
    elif mode == "resume":
        pos = np.array([3, 9])[:, None] + np.arange(s)[None]
        sv = np.arange(s)[None] < np.array([[s], [7]])
        kw = dict(resume=True, seq_valid=sv)
        tkw = dict(resume=True, seq_valid=torch.from_numpy(sv))
    else:
        pos = np.broadcast_to(np.arange(s), (b, s))
    jmode = "prefill" if mode == "resume" else mode
    jc = None if mode == "train" else {n: jnp.asarray(a)
                                       for n, a in cache.items()}
    jx, jnew = jlayers.apply_self_attn(jblock, x, cfg=jcfg, mode=jmode,
                                       positions=pos, cache=jc, **kw)
    tc = None if mode == "train" else {n: torch.from_numpy(a.copy())
                                       for n, a in cache.items()}
    tx, tnew = layers.apply_self_attn(tblock, torch.from_numpy(x), cfg=tcfg,
                                      mode=jmode, positions=torch.from_numpy(
                                          np.ascontiguousarray(pos)),
                                      cache=tc, **tkw)
    _close(tx, jx)
    if mode != "train":
        for n in ("k", "v"):
            _close(tnew[n], jnew[n])


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_paged_decode_layer_matches_reference(pair, kv):
    """The S = 1 paged decode branch on a small arena: row 0 live, row 1
    wrapped and sharing row 0's first page, row 2 frozen (its write goes to
    its trash cell), fp and int8 pages — output and arena after the write
    against the reference's layer."""
    jcfg, tcfg, jp, tp = pair
    from repro.kernels.quant_matmul import quantize_kv_int8 as jq
    jblock = jax.tree.map(lambda a: a[0], jp["block"]["pos0"]["attn"])
    tblock = model.tree_map(lambda a: a[0], tp["block"]["pos0"]["attn"])
    rng = np.random.default_rng(6)
    b, ps, n, hkv, hd = 3, 4, 12, jcfg.num_kv_heads, jcfg.head_dim
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    arena = {name: rng.standard_normal((n, ps, hkv, hd)).astype(np.float32)
             for name in ("k", "v")}
    if kv == "int8":
        for name in ("k", "v"):
            qv, sc = jq(arena[name])
            arena[name], arena[name + "_scale"] = np.asarray(qv), np.asarray(sc)
    table = np.array([[2, 3, 4], [2, 5, 6], [7, 8, 0]], np.int32)
    pos = np.array([[6], [13], [9]])
    active = np.array([True, True, False])
    jx, jnew = jlayers.apply_self_attn(
        jblock, x, cfg=jcfg, mode="decode", positions=pos,
        cache={k: jnp.asarray(a) for k, a in arena.items()},
        page_table=jnp.asarray(table), slot_active=jnp.asarray(active))
    tc = {k: torch.from_numpy(a.copy()) for k, a in arena.items()}
    tx, tnew = layers.apply_self_attn(
        tblock, torch.from_numpy(x), cfg=tcfg, mode="decode",
        positions=torch.from_numpy(pos), cache=tc,
        page_table=torch.from_numpy(table),
        slot_active=torch.from_numpy(active))
    _close(tx, jx)
    assert tnew is tc
    for name, leaf in tc.items():
        np.testing.assert_allclose(_np_t(leaf), np.asarray(jnew[name]),
                                   atol=1e-6, err_msg=name)
    assert not np.array_equal(_np_t(tc["k"])[0, 2], arena["k"][0, 2])


def _np_t(t):
    return t.float().numpy() if t.dtype == torch.int8 else t.numpy()


def test_unported_branches_name_their_roadmap_item(pair):
    _, tcfg, _, tp = pair
    attn = model.tree_map(lambda a: a[0], tp["block"]["pos0"]["attn"])
    x = torch.zeros((1, 2, tcfg.d_model))
    cache = model.init_cache(tcfg, 1, 8, device="cpu")["block"]["pos0"]
    cache = model.tree_map(lambda a: a[0], cache)
    with pytest.raises(NotImplementedError, match="speculative decoding"):
        layers.apply_self_attn(attn, x, cfg=tcfg, mode="decode",
                               positions=torch.zeros((1, 2), dtype=torch.long),
                               cache=cache)
    with pytest.raises(NotImplementedError, match="speculative decoding"):
        layers.apply_self_attn(attn, x, cfg=tcfg, mode="decode",
                               positions=torch.zeros((1, 2), dtype=torch.long),
                               cache=cache, page_table=torch.zeros(
                                   (1, 1), dtype=torch.int32))
    for kind, item in (("moe", "MoE"), ("ssm", "SSM")):
        with pytest.raises(NotImplementedError, match=item):
            layers.init_layer(torch.Generator(), kind, tcfg)
    audio = dataclasses.replace(tcfg, family="audio", audio=AudioConfig(
        embed_dim=64, num_frames=16, encoder_layers=2))
    with pytest.raises(NotImplementedError, match="multimodal \\(audio\\)"):
        model.Model(audio).init(torch.Generator(), "cpu")


# --------------------------------------------------------------------------- #
# Model.apply logits in every mode
# --------------------------------------------------------------------------- #
def test_model_train_and_prefill_logits_match_reference(pair):
    jcfg, tcfg, jp, tp = pair
    jm, tm = jmodel.build_model(jcfg), model.Model(tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 20))
    tt = torch.from_numpy(toks)
    jout = jm.apply(jp, toks, mode="train")
    _close(tm.apply(tp, tt, mode="train").logits, jout.logits)
    jout = jm.apply(jp, toks, mode="prefill",
                    cache=jmodel.init_cache(jcfg, 2, 32), logits_mode="last")
    tcache = model.init_cache(tcfg, 2, 32, device="cpu")
    tout = tm.apply(tp, tt, mode="prefill", cache=tcache, logits_mode="last")
    _close(tout.logits, jout.logits)
    for (key, a), (_, b) in zip(_leaves(jout.cache), _leaves(tout.cache)):
        _close(b, a)


def test_model_resume_prefill_and_decode_logits_match_reference(pair):
    """Two chunks of resume-prefill (ragged rows, ``seq_valid``), then three
    decode steps, logits and caches compared at every call."""
    jcfg, tcfg, jp, tp = pair
    jm, tm = jmodel.build_model(jcfg), model.Model(tcfg)
    rng = np.random.default_rng(3)
    b, chunk, cache_len = 2, 16, 48
    toks = rng.integers(0, jcfg.vocab_size, (b, 2 * chunk))
    lengths = np.array([2 * chunk, chunk + 5])
    jc = jmodel.init_cache(jcfg, b, cache_len)
    tc = model.init_cache(tcfg, b, cache_len, device="cpu")
    for c in range(2):
        pos = c * chunk + np.broadcast_to(np.arange(chunk), (b, chunk))
        sv = pos < lengths[:, None]
        seg = toks[:, c * chunk:(c + 1) * chunk]
        jout = jm.apply(jp, seg, mode="prefill", positions=pos, cache=jc,
                        resume=True, seq_valid=sv)
        jc = jout.cache
        tout = tm.apply(tp, torch.from_numpy(seg), mode="prefill",
                        positions=torch.from_numpy(pos.copy()), cache=tc,
                        resume=True, seq_valid=torch.from_numpy(sv))
        _close(tout.logits, jout.logits)
    # last_idx takes each row's logits at its own last real token
    last = torch.from_numpy(lengths - chunk - 1)
    tl = tm.apply(tp, torch.from_numpy(seg), mode="prefill",
                  positions=torch.from_numpy(pos.copy()),
                  cache=model.tree_map(torch.clone, tc), resume=True,
                  seq_valid=torch.from_numpy(sv), last_idx=last).logits
    _close(tl[:, 0], np.asarray(jout.logits)[np.arange(b), lengths - chunk - 1])
    nxt = np.asarray(jout.logits)[np.arange(b), lengths - chunk - 1].argmax(-1)
    pos = lengths.copy()
    for _ in range(3):
        jout = jm.apply(jp, nxt[:, None], mode="decode", positions=pos[:, None],
                        cache=jc)
        jc = jout.cache
        tout = tm.apply(tp, torch.from_numpy(nxt[:, None]), mode="decode",
                        positions=torch.from_numpy(pos[:, None]), cache=tc)
        _close(tout.logits, jout.logits)
        nxt, pos = np.asarray(jout.logits)[:, 0].argmax(-1), pos + 1
    for (key, a), (_, b_) in zip(_leaves(jc), _leaves(tc)):
        _close(b_, a)


def test_frozen_decode_slot_keeps_its_cache(pair):
    """slot_active False rewrites the written cell with its old value (the
    in-place form of the reference's select_cache_slots)."""
    _, tcfg, _, tp = pair
    tm = model.Model(tcfg)
    tc = model.init_cache(tcfg, 2, 16, device="cpu")
    for leaf in model.tree_leaves(tc):
        leaf.normal_(generator=torch.Generator().manual_seed(4))
    before = model.tree_map(torch.clone, tc)
    tm.apply(tp, torch.tensor([[3], [4]]), mode="decode",
             positions=torch.tensor([[5], [6]]), cache=tc,
             slot_active=torch.tensor([True, False]))
    for a, b in zip(model.tree_leaves(before), model.tree_leaves(tc)):
        assert torch.equal(a[..., 1, :, :, :], b[..., 1, :, :, :])
        assert not torch.equal(a[..., 0, 5, :, :], b[..., 0, 5, :, :])


# --------------------------------------------------------------------------- #
# entry points run on the card unless the CPU is asked for
# --------------------------------------------------------------------------- #
_HELPERS = {
    "Model.init": lambda cfg, **kw: model.Model(cfg).init(
        torch.Generator().manual_seed(0), **kw),
    "init_cache": lambda cfg, **kw: model.init_cache(cfg, 1, 8, **kw),
    "init_decode_state": lambda cfg, **kw: init_decode_state(4, 2, **kw),
    "SlotKVPool": lambda cfg, **kw: SlotKVPool(cfg, 2, 8, **kw),
    "PagedKVPool": lambda cfg, **kw: PagedKVPool(cfg, 2, 8, page_size=4,
                                                 **kw),
    "params_from_jax": lambda cfg, **kw: params_from_jax(
        {"embed": np.zeros((4, 2), np.float32)}, cfg, **kw),
}


@pytest.mark.parametrize("name", sorted(_HELPERS))
def test_helpers_need_cuda_unless_cpu_is_asked_for(name, monkeypatch):
    cfg = get_config("qwen3-0.6b-toy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _HELPERS[name](cfg)
    out = _HELPERS[name](cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in model.tree_leaves(
        out.cache if name.endswith("KVPool") else
        vars(out) if name == "init_decode_state" else out))


# --------------------------------------------------------------------------- #
# import rules of the port
# --------------------------------------------------------------------------- #
def test_port_imports_without_jax_or_the_reference():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(PORT.parent),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_name_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)"
                         r"|\bjax\.|\bjnp\.|\brepro\.", re.M)
    offenders = [f"{p.relative_to(PORT)}:{m.group(0).strip()}"
                 for p in PORT.rglob("*.py")
                 for m in pattern.finditer(p.read_text())]
    assert not offenders, offenders
