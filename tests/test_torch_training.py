"""The port's training substrate against the JAX package on the CPU: the
schedule, AdamW on a tree with bf16 leaves and stacked 1-D leaves (decayed,
as the reference decays every ``ndim >= 2`` leaf) with clipping active, the
bigram pipeline bit for bit, three ``make_train_step`` steps against the
reference's jitted step with ``microbatches`` 1 and 2, remat on equal to
off bit for bit, the loss falling on ``qwen3-0.6b-toy`` (the reference's
own test, mirrored), the MoE aux loss present, and the launcher and the
example end to end.

Inputs come from numpy seeds, weights from one JAX ``init_train_state``
bridged with ``params_from_jax``; float32 unless named.  Tolerances: the
schedule and the optimizer's metrics rtol 1e-6 (the same float32 formula;
``cos`` may differ by an ulp); AdamW moments rtol 1e-6 and params within
one bf16 ulp (the update is float32, then rounded to the leaf's dtype);
after three train steps the metrics rtol 1e-5 and the moments 1e-4 of each
leaf's largest entry (gradients summed in another order), and params
within 2e-4 (a fifth of one step of lr 1e-3) wherever the reference's
first moment is at least 1e-7.  Below that Adam's direction ``m /
sqrt(v)`` is the sign of float32 noise (``qwen2-0.5b``'s key bias has an
analytically zero gradient: a constant added to every key of a row does
not move its softmax), and those entries are held to what any three steps
obey, 2 x 3 x lr.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.training import train_step as jts
from repro.training.data import BigramDataPipeline as JaxPipeline
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro.training.optimizer import lr_at as jax_lr_at
from repro_torch.configs import get_config
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import params_from_jax
from repro_torch.training import train_step as tts
from repro_torch.training.checkpoint import restore_checkpoint
from repro_torch.training.data import BigramDataPipeline
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            lr_at, tree_flatten_with_path,
                                            tree_leaves)
from torch_threads import one_torch_thread  # noqa: F401

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEP_LR = OPT["lr"]
M_FLOOR = 1e-7


def _f32(cfg):
    return dataclasses.replace(cfg.reduced(), dtype="float32")


def _pair(name):
    """(jax cfg, torch cfg, jax train state, torch train state), reduced,
    float32, the port's weights bridged from the reference's."""
    jcfg, tcfg = _f32(jax_get_config(name)), _f32(get_config(name))
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = tts.init_train_state(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg, "cpu"))
    return jcfg, tcfg, jstate, tstate


def _jax_leaves(tree):
    return [np.asarray(a) for _, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


# --------------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 40, 99, 100, 150])
def test_lr_at_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(jax_lr_at(JaxAdamWConfig(**cfg), jnp.asarray(step)))
    got = lr_at(AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def _opt_tree(rng, dtype_np, dtype_t):
    """A params tree with a bf16 matrix, stacked [repeats, D] vectors (a
    norm weight and a bias), an un-stacked prefix vector and a float32
    leaf, as numpy (for JAX) and torch."""
    shapes = {"block": {"pos0": {"ln": (3, 8), "bq": (3, 8),
                                 "wq": (3, 8, 8)}},
              "embed": (16, 8), "prefix_layers": [{"ln": (8,)}],
              "router": (8, 4)}

    def walk(t, path=""):
        if isinstance(t, dict):
            return {k: walk(v, path + "/" + k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path) for v in t]
        a = rng.standard_normal(t).astype(np.float32)
        return a if path.endswith("router") else a.astype(dtype_np)
    np_tree = walk(shapes)
    to_t = lambda a: (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.float32 if a.dtype == np.float32 else dtype_t))
    return np_tree, jax.tree.map(to_t, np_tree)


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_adamw_matches_jax_for_three_steps(clip_norm):
    """Three AdamW steps on bf16 and float32 leaves, stacked 1-D leaves
    decayed (``ndim >= 2``) and the prefix vector not; clipping active at
    clip_norm 1 (gradient norms ~10)."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    np_p, tp = _opt_tree(rng, ml_dtypes.bfloat16, torch.bfloat16)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, clip_norm=clip_norm,
               weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, np_p)
    jopt = jax_init_opt_state(jp)
    topt = init_opt_state(tp)
    for step in range(3):
        np_g, tg = _opt_tree(np.random.default_rng(10 + step),
                             ml_dtypes.bfloat16, torch.bfloat16)
        jp, jopt, jm = jax_adamw_update(JaxAdamWConfig(**cfg), jp,
                                        jax.tree.map(jnp.asarray, np_g), jopt)
        tp, topt, tm = adamw_update(AdamWConfig(**cfg), tp, tg, topt)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    for got, want in zip(tree_leaves(tp), _jax_leaves(jp)):
        want = np.asarray(want, np.float32)
        ulp = np.abs(want) * 2.0 ** -8 if got.dtype == torch.bfloat16 \
            else np.abs(want) * 1e-6
        assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-12)
    for key in ("m", "v"):
        for got, want in zip(tree_leaves(topt[key]), _jax_leaves(jopt[key])):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-12)
    if clip_norm == 1.0:
        assert float(tm["grad_norm"]) > 1.0


def test_adamw_updates_the_trees_in_place():
    """The step writes into the given tensors (no copy of params or
    moments), and its first step is AdamW's: ``p - lr (g / (|g| + eps) +
    wd p)`` on a matrix, without the decay on a vector (``lr`` the
    schedule's at step 1)."""
    rng = np.random.default_rng(1)
    _, tp = _opt_tree(rng, np.float32, torch.float32)
    _, tg = _opt_tree(rng, np.float32, torch.float32)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=5, clip_norm=1e9)
    before = {id(t): t.clone() for t in tree_leaves(tp)}
    opt = init_opt_state(tp)
    ptrs = [t.data_ptr() for t in tree_leaves([tp, opt])]
    got_p, got_o, metrics = adamw_update(cfg, tp, tg, opt)
    assert got_p is tp and got_o is opt
    assert [t.data_ptr() for t in tree_leaves([got_p, got_o])] == ptrs
    for p, g in zip(tree_leaves(tp), tree_leaves(tg)):
        p0, g = before[id(p)].double(), g.double()
        delta = g / (g.abs() + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p0
        want = p0 - float(metrics["lr"]) * delta
        np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_global_norm_and_leaf_order():
    assert abs(float(global_norm({"a": torch.tensor([3.0, 4.0])})) - 5) < 1e-6
    tree = {"b": [torch.ones(1), {"z": torch.ones(2), "a": torch.ones(3)}],
            "a": torch.ones(4)}
    assert [p for p, _ in tree_flatten_with_path(tree)] == [
        ("a",), ("b", 0), ("b", 1, "a"), ("b", 1, "z")]


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 32, 4, 3),
                                                  (151936, 64, 2, 0)])
def test_data_pipeline_matches_jax_bit_for_bit(vocab, seq, batch, seed):
    ours = BigramDataPipeline(vocab, seq, batch, seed=seed)
    ref = JaxPipeline(vocab, seq, batch, seed=seed)
    for step in (0, 1, 7):
        a, b = ours.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------- #
# the train step against the reference's
# --------------------------------------------------------------------------- #
def _jpath(path):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _check_state(tstate, jstate, steps):
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tflat = tree_flatten_with_path(tstate)
    assert [_jpath(p) for p, _ in jflat] == [tuple(map(str, p))
                                             for p, _ in tflat]
    jm = {_jpath(p)[2:]: np.asarray(a) for p, a in jflat
          if _jpath(p)[:2] == ("opt", "m")}
    for (path, got), (_, want) in zip(tflat, jflat):
        got, want = got.numpy(), np.asarray(want)
        if path[0] == "opt":
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= 1e-4 * scale, path
            continue
        sharp = np.abs(jm[tuple(map(str, path))[1:]]) >= M_FLOOR
        diff = np.abs(got - want)
        assert diff[sharp].max(initial=0) <= 2e-4, path
        assert diff.max() <= 2 * steps * STEP_LR, path


@pytest.mark.parametrize("name,microbatches", [
    ("qwen2-0.5b", 1), ("qwen2-0.5b", 2), ("qwen3-30b-a3b-toy", 2)])
def test_train_steps_match_jax_jitted_step(name, microbatches):
    jcfg, tcfg, jstate, tstate = _pair(name)
    jstep = jax.jit(jts.make_train_step(jcfg, JaxAdamWConfig(**OPT),
                                        remat=False,
                                        microbatches=microbatches))
    tstep = tts.make_train_step(tcfg, AdamWConfig(**OPT), remat=False,
                                microbatches=microbatches)
    data = BigramDataPipeline(jcfg.vocab_size, 16, 4, seed=1)
    for i in range(3):
        batch = data.batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm)
        for k in tm:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    _check_state(tstate, jstate, 3)
    assert all(not t.requires_grad for t in tree_leaves(tstate))


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-30b-a3b-toy",
                                  "mamba2-780m"])
def test_remat_on_equals_off_bit_for_bit(name):
    _, tcfg, _, tstate = _pair(name)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (2, 20))
    batch = tts.batch_to({"tokens": toks, "labels": np.roll(toks, -1, 1),
                          "mask": np.ones((2, 20), np.float32)}, "cpu")
    runs = [tts.loss_and_grads(tstate["params"], batch, cfg=tcfg, remat=r)
            for r in (False, True)]
    (l0, p0, g0), (l1, p1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(p0["aux_loss"], p1["aux_loss"])
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(g is not None for g in g0)


def test_loss_decreases_over_training():
    """The reference's ``test_loss_decreases_over_training``, mirrored."""
    cfg = get_config("qwen3-0.6b-toy")
    data = BigramDataPipeline(256, seq_len=64, batch_size=8)
    state = tts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    step = tts.make_train_step(
        cfg, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40),
        remat=False)
    losses = []
    for i in range(25):
        state, metrics = step(state, data.batch(i))
        losses.append(metrics["loss"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_moe_aux_loss_present():
    cfg = get_config("qwen3-30b-a3b-toy")
    data = BigramDataPipeline(cfg.vocab_size, seq_len=32, batch_size=2)
    state = tts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    _, metrics = tts.make_train_step(cfg, AdamWConfig(), remat=False)(
        state, data.batch(0))
    assert metrics["aux_loss"] > 0.0
    assert abs(metrics["loss"] - metrics["lm_loss"]
               - metrics["aux_loss"]) < 1e-5


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,extra", [
    ("qwen2-0.5b", []), ("qwen2-0.5b", ["--remat", "--microbatches", "2"]),
    ("qwen3-vl-toy", []), ("seamless-m4t-medium", [])])
def test_launcher_trains_on_the_cpu(tmp_path, arch, extra):
    path = os.path.join(tmp_path, "ckpt.npz")
    out = train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--steps", "3", "--batch", "2", "--seq", "16",
                               "--checkpoint", path] + extra)
    assert out["steps"] == 3 and np.isfinite(out["last_loss"])
    cfg = get_config(arch).reduced()
    like = tts.init_train_state(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    restored = restore_checkpoint(path, like)
    assert int(restored["opt"]["step"]) == 3


def test_train_tiny_example_round_trips_its_checkpoint():
    from repro_torch.examples import train_tiny
    assert train_tiny.main(["--steps", "3", "--device", "cpu"])
