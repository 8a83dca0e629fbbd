"""The port's multi-pod dry-run machinery on the CPU, against the JAX
package where it has a counterpart.

* the causal-blocks schedule (``ops.flash_causal_blocks``) against the
  reference's ``_flash_jnp_causal_blocks`` in float32 (1e-5), and
  ``Model.apply(attn_schedule="causal")`` logits against the reference's
  (1e-4, reduced ``qwen2-0.5b`` over 2048 tokens: two q chunks);
* ``build_step_spec``'s steps as meta DTensors on a fake 2 x 2 mesh
  (reduced configs, tiny ``SHAPES``): every step kind, the three
  ``moe_shard`` variants and the two decode layouts (the reference's
  ``test_perf_variants.py`` cases); each runs with its outputs placed as
  ``out_shardings`` says;
* on a 1 x 1 gloo mesh of real CPU tensors, the steps' outputs equal the
  no-mesh outputs bit for bit;
* ``dryrun.main`` writes a record with the reference's keys.

The fake process group is set up and torn down around each test by a
fixture.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.distributed import placements
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import _group, make_host_mesh
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

TINY_SHAPES = {
    "train_4k": dict(seq=32, batch=4, kind="train"),
    "prefill_32k": dict(seq=32, batch=4, kind="prefill"),
    "decode_32k": dict(seq=32, batch=4, kind="decode"),
    "long_500k": dict(seq=64, batch=1, kind="decode"),
}
RECORD_KEYS = {
    "arch", "shape", "mesh", "chips", "step", "attn_schedule", "unrolled",
    "moe_shard", "layout", "microbatches", "fsdp", "flops_per_device",
    "bytes_per_device", "collective_bytes_per_device", "collectives",
    "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
    "model_flops_global", "useful_flop_frac", "notes", "ok"}


@pytest.fixture
def tiny_shapes(monkeypatch):
    monkeypatch.setattr(specs, "SHAPES", dict(TINY_SHAPES))


@pytest.fixture
def fake_mesh():
    """A fake process group of 4 ranks and a (2, 2) (data, model) mesh on
    it, torn down after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    with _group("fake", 4, FakeStore()):
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))


# --------------------------------------------------------------------------- #
# the causal-blocks schedule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sq,skv,h,hkv,window,q_offset", [
    (256, 256, 4, 2, 0, 0),
    (256, 256, 6, 1, 100, 0),
    (192, 320, 4, 4, 0, 128),
])
def test_causal_blocks_match_reference(sq, skv, h, hkv, window, q_offset):
    rng = np.random.default_rng(sq + window)
    q = rng.standard_normal((2, sq, h, 32)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, 32)).astype(np.float32)
    v = rng.standard_normal((2, skv, hkv, 32)).astype(np.float32)
    want = jops._flash_jnp_causal_blocks(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        q_offset=q_offset, chunk=64)
    got = ops.flash_causal_blocks(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  q_offset=q_offset, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_model_causal_schedule_logits_match_reference():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    jm, tm = jmodel.build_model(jcfg), model.Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 2048))
    want = jm.apply(jp, jnp.asarray(toks, jnp.int32), mode="train",
                    attn_schedule="causal").logits
    calls = []
    real = ops.flash_causal_blocks
    ops.flash_causal_blocks = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        got = tm.apply(tp, torch.from_numpy(toks), mode="train",
                       attn_schedule="causal").logits
    finally:
        ops.flash_causal_blocks = real
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------------------------------- #
# the steps over meta DTensors on a fake 2 x 2 mesh
# --------------------------------------------------------------------------- #
def _run(cfg, shape, mesh, **rule_kw):
    rules = specs.shape_rules(cfg, shape, mesh, **rule_kw)
    spec = specs.build_step_spec(cfg, shape)
    res = dryrun.run_step(spec, mesh, rules)
    placed = []
    dryrun._zip_args(lambda t, sp: placed.append(
        tuple(t.placements) == placements(sp, mesh)), res["out"],
        res["out_specs"])
    assert placed and all(placed)
    counter = res["counter"]
    assert counter.flops > 0 and counter.bytes > 0
    return res


@pytest.mark.parametrize("shape", list(TINY_SHAPES))
def test_step_kinds_on_fake_mesh(tiny_shapes, fake_mesh, shape):
    res = _run(get_config("qwen2-0.5b").reduced(), shape, fake_mesh)
    assert res["argument_bytes"] > 0


@pytest.mark.parametrize("moe_shard", ["fsdp", "2d", "ep"])
def test_moe_variants_on_fake_mesh(tiny_shapes, fake_mesh, moe_shard):
    res = _run(get_config("grok-1-314b").reduced(), "train_4k", fake_mesh,
               fsdp=True, moe_shard=moe_shard)
    assert sum(res["counter"].collectives.values()) > 0


@pytest.mark.parametrize("layout", ["dp", "2dtp"])
def test_decode_layouts_on_fake_mesh(tiny_shapes, fake_mesh, layout):
    _run(get_config("jamba-1.5-large-398b").reduced(), "decode_32k",
         fake_mesh, fsdp=True, layout=layout,
         moe_shard="2d" if layout == "2dtp" else "fsdp")


# --------------------------------------------------------------------------- #
# a 1 x 1 gloo mesh of real tensors: bit for bit the no-mesh steps
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", list(TINY_SHAPES))
def test_host_mesh_steps_equal_no_mesh(tiny_shapes, shape):
    cfg = get_config("qwen2-0.5b").reduced()
    spec = specs.build_step_spec(cfg, shape)
    args = specs.materialize(spec.args, torch.Generator().manual_seed(0),
                             "cpu", high=TINY_SHAPES[shape]["seq"])
    want = list(model.tree_leaves(spec.fn(*model.tree_map(torch.clone,
                                                          args))))
    with make_host_mesh(device="cpu") as mesh:
        rules = specs.shape_rules(cfg, shape, mesh)
        res = dryrun.run_step(dataclasses.replace(
            spec, args=model.tree_map(torch.clone, args)), mesh, rules)
        got = [t.full_tensor() for t in model.tree_leaves(res["out"])]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the command line
# --------------------------------------------------------------------------- #
def test_main_writes_records(tmp_path):
    argv = ["--arch", "qwen2-0.5b", "--shape", "long_500k", "--save-dir",
            str(tmp_path)]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / "qwen2-0.5b_long_500k.json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["ok"] and rec["chips"] == 256
    assert rec["argument_bytes_per_device"] > 0 and rec["fits_card"]
    assert rec["notes"].startswith("sliding-window")
    assert dryrun.main(argv + ["--multi-pod"]) == 0
    rec = json.loads((tmp_path / "qwen2-0.5b_long_500k_mp.json").read_text())
    assert rec["ok"] and rec["chips"] == 512 and rec["mesh"] == "2x16x16"


def test_apply_keeps_no_reference_to_its_cache():
    """``Model.apply`` leaves nothing holding its cache once it returns:
    with no reference cycle the engine's old arena is freed the moment a
    rebuild drops it (the card's 4j-d bounds that rebuild's peak)."""
    import gc
    import weakref
    cfg = get_config("qwen2-0.5b").reduced()
    m = model.Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    ref = weakref.ref(cache["block"]["pos0"]["k"])
    gc.disable()
    try:
        m.apply(params, torch.zeros((2, 1), dtype=torch.long), mode="decode",
                positions=torch.zeros((2, 1), dtype=torch.long), cache=cache)
        del cache
        assert ref() is None
    finally:
        gc.enable()
