"""The port's logical-axis sharding against the JAX package's, exactly, on
the production meshes without devices: the reference's rules run on
``jax.sharding.AbstractMesh`` (16, 16) and (2, 16, 16), the port's on a
``MeshView`` of the same axes.

* ``default_rules`` / ``shape_rules`` equal for every architecture x input
  shape x ``fsdp`` x ``moe_shard`` x ``layout``;
* for all 10 dry-run architectures at published widths, every leaf of the
  step arguments ``build_step_spec`` gives (params, AdamW state, caches,
  batch) gets the reference's spec, its per-device shape equals
  ``NamedSharding(mesh, spec).shard_shape(shape)``, and the argument bytes
  per device are equal;
* ``sanitize_spec`` on the reference's ``FakeMesh`` cases;
* ``placements`` (spec -> DTensor placements) and ``constrain`` as identity
  with no mesh or on a plain tensor.
"""
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import jax
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import sanitize_spec as jax_sanitize
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.distributed import constrain, placements, use_sharding
from repro_torch.distributed.sharding import MeshView, sanitize_spec
from repro_torch.launch import specs
from repro_torch.launch.dryrun import ALL_ARCHS, ALL_SHAPES, _local_shape
from repro_torch.training.optimizer import tree_flatten_with_path
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return (AbstractMesh(sizes, names),
            MeshView(names, dict(zip(names, sizes))))


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries (a jax ``PartitionSpec`` or
    the port's tuple)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_equal_reference(mesh, arch):
    am, view = _meshes(mesh)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for shape in ALL_SHAPES:
        for fsdp in (None, False, True):
            for moe in ("fsdp", "2d", "ep"):
                for layout in ("dp", "2dtp"):
                    want = jspecs.shape_rules(jcfg, shape, am, fsdp=fsdp,
                                              moe_shard=moe, layout=layout)
                    got = specs.shape_rules(cfg, shape, view, fsdp=fsdp,
                                            moe_shard=moe, layout=layout)
                    assert got == want, (shape, fsdp, moe, layout)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_step_leaf_specs_equal_reference(mesh, arch):
    """Every argument leaf of the four step kinds: spec, per-device shape
    and the argument bytes per device, against the reference's."""
    am, view = _meshes(mesh)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for shape in ALL_SHAPES:
        jspec = jspecs.build_step_spec(jcfg, shape)
        spec = specs.build_step_spec(cfg, shape)
        jrules = jspecs.shape_rules(jcfg, shape, am)
        rules = specs.shape_rules(cfg, shape, view)
        want = jax.tree_util.tree_flatten_with_path(jspec.args)[0]
        want_sh = jax.tree_util.tree_leaves(jspec.in_shardings(am, jrules))
        got = tree_flatten_with_path(list(spec.args))
        got_sh = spec.in_shardings(view, rules)
        assert len(got) == len(want) == len(want_sh), shape
        jbytes = tbytes = 0
        for (path, leaf), (jpath, jleaf), jsh in zip(got, want, want_sh):
            where = (shape, path)
            assert tuple(leaf.shape) == tuple(jleaf.shape), where
            assert leaf.element_size() == jleaf.dtype.itemsize, where
            sp = _at(got_sh, path)
            assert _norm(sp, leaf.dim()) == _norm(jsh.spec, leaf.dim()), where
            local = _local_shape(tuple(leaf.shape), sp, view)
            jlocal = NamedSharding(am, jsh.spec).shard_shape(jleaf.shape)
            assert local == tuple(jlocal), where
            n = 1
            for d in local:
                n *= d
            tbytes += n * leaf.element_size()
            jn = 1
            for d in jlocal:
                jn *= d
            jbytes += jn * jleaf.dtype.itemsize
        assert tbytes == jbytes, shape


FAKE_CASES = [
    (("data", "model"), (10, 16)),
    (("data", "model"), (50280, 32)),
    (("model", "model"), (32, 32)),
    ((("data", "model"), None), (256, 7)),
    ((("data", "model"), "model"), (512, 32)),
    (("data", ("data", "model")), (32, 512)),
    ((None, ("pod", "data")), (3, 64)),
    (("model",), (48, 5, 7)),
    ((), (4,)),
]


@pytest.mark.parametrize("axes,shape", FAKE_CASES)
def test_sanitize_spec_fake_mesh(axes, shape):
    class FakeMesh:
        shape = {"pod": 2, "data": 16, "model": 16}
        axis_names = ("pod", "data", "model")

    want = jax_sanitize(P(*axes), shape, FakeMesh())
    got = sanitize_spec(axes, shape, FakeMesh())
    assert _norm(got, len(shape)) == _norm(want, len(shape))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    view = MeshView(("pod", "data", "model"),
                    {"pod": 2, "data": 16, "model": 16})
    assert placements((None, ("pod", "data"), "model"), view) == (
        Shard(1), Shard(1), Shard(2))
    assert placements(("model", None), view) == (
        Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError):
        placements((("model", "data"),), view)      # not in mesh order


def test_constrain_is_identity_without_mesh_or_dtensor():
    x = torch.ones((4, 4))
    assert constrain(x, "batch", "tp") is x
    view = MeshView(("data", "model"), {"data": 1, "model": 1})
    with use_sharding(view, specs.shape_rules(get_config("qwen2-0.5b"),
                                              "train_4k", view)):
        assert constrain(x, "batch", "tp") is x
