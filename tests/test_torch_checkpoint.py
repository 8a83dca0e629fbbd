"""The port's checkpoints against the JAX package's: the same ``.npz`` keys
for the same train state, a JAX-written float32 and bf16 checkpoint
restored by the port bit for bit, a port-written float32 checkpoint
restored by the reference's ``restore_checkpoint``, and the port's own bf16
round trip.  The reference writes a bf16 leaf's raw bits as ``|V2`` and
cannot read them back itself (``astype`` has no cast from ``V2``); the port
reinterprets those bits.  Everything here is exact."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.training import checkpoint as jckpt
from repro.training import train_step as jts
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import train_step as tts
from repro_torch.training.optimizer import tree_flatten_with_path, tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ["qwen2-0.5b", "qwen3-30b-a3b-toy", "jamba-1.5-large-398b"]


def _states(name, dtype, seed=0):
    """(JAX train state, the port's state holding the same values)."""
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(seed))
    tstate = tts.init_train_state(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg, "cpu"))
    return jstate, tstate


def _bits(a):
    """An array's raw bits (bf16 as uint16) for exact comparisons."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16
             else a).numpy()
    return np.asarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keys_equal_the_reference(tmp_path, name, dtype):
    jstate, tstate = _states(name, dtype)
    jpath, tpath = (os.path.join(tmp_path, f) for f in ("j.npz", "t.npz"))
    jckpt.save_checkpoint(jpath, jstate, step=3)
    ckpt.save_checkpoint(tpath, tstate, step=3)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/block/pos0/attn/wq" in a.files or name != "qwen2-0.5b"
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].shape == b[key].shape, key
    assert ckpt.checkpoint_step(jpath) == ckpt.checkpoint_step(tpath) == 3


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, name, dtype):
    jstate, _ = _states(name, dtype, seed=1)
    _, like = _states(name, dtype, seed=2)
    path = os.path.join(tmp_path, "j.npz")
    jckpt.save_checkpoint(path, jstate, step=5)
    got = ckpt.restore_checkpoint(path, like)
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    for (p, leaf), (_, w), l0 in zip(tree_flatten_with_path(got), want,
                                     tree_leaves(like)):
        assert leaf.dtype == l0.dtype and tuple(leaf.shape) == w.shape, p
        np.testing.assert_array_equal(_bits(leaf), _bits(w), err_msg=str(p))


@pytest.mark.parametrize("name", NAMES)
def test_port_float32_checkpoint_restores_in_the_reference(tmp_path, name):
    _, tstate = _states(name, "float32", seed=3)
    jlike, _ = _states(name, "float32", seed=4)
    path = os.path.join(tmp_path, "t.npz")
    ckpt.save_checkpoint(path, tstate, step=2)
    got = jckpt.restore_checkpoint(path, jlike)
    assert jckpt.checkpoint_step(path) == 2
    for a, b in zip(jax.tree.leaves(got), tree_leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_port_bf16_round_trip_and_the_reference_quirk(tmp_path):
    jstate, tstate = _states("qwen2-0.5b", "bfloat16", seed=5)
    path = os.path.join(tmp_path, "t.npz")
    ckpt.save_checkpoint(path, tstate, step=1)
    with np.load(path) as data:
        assert data["params/embed"].dtype.str == "|V2"
    back = ckpt.restore_checkpoint(path, tstate)
    for a, b in zip(tree_leaves(back), tree_leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference's own restore of a bf16 checkpoint raises
    jckpt.save_checkpoint(path, jstate)
    with pytest.raises((ValueError, TypeError)):
        jckpt.restore_checkpoint(path, jstate)


def test_restore_checks_keys_and_shapes(tmp_path):
    _, tstate = _states("qwen2-0.5b", "float32")
    path = os.path.join(tmp_path, "t.npz")
    ckpt.save_checkpoint(path, {"params": tstate["params"]})
    with pytest.raises(KeyError, match="opt/"):
        ckpt.restore_checkpoint(path, tstate)
    bad = {"params": dict(tstate["params"],
                          embed=torch.zeros((3, 3)))}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(path, bad)
