"""Logical-axis sharding of the port: model code names *logical* axes; a
rules table maps them to mesh axes.  With no active mesh every helper is a
no-op, so the same model code runs on one device (the engine, the tests)
and over a torch ``DeviceMesh`` of DTensors (the host-mesh steps, the
multi-pod dry-run) unchanged.

A copy of the reference's ``distributed/sharding.py`` host logic (the port
imports nothing of the reference).  A *spec* is a tuple with one entry per
tensor dim: ``None`` (not sharded), a mesh axis name, or a tuple of mesh
axis names (the dim split over those axes, the first one major) — the
reference's ``PartitionSpec`` as a plain tuple.  The rules and
:func:`sanitize_spec` read only a mesh's ``axis_names`` and its name ->
size ``shape``; :func:`mesh_view` gives those for a torch ``DeviceMesh``
(``mesh_dim_names`` and a size tuple).  :func:`placements` turns a spec
into DTensor placements, and :func:`constrain` redistributes a DTensor to
the spec its logical axes name.

Baseline rules (single pod, mesh ('data','model')):
    batch    -> data            activations' batch dim
    tp       -> model           tensor-parallel dim (heads / ffn / vocab-out)
    fsdp     -> data | None     weight-shard dim (ZeRO-3 style), on for >=4B
    kv_seq   -> model           decode KV cache sequence dim
    expert   -> None            expert dim of stacked expert weights

Multi-pod prepends 'pod' to the batch rule; long_500k (batch=1) re-points
batch->None and kv_seq->(pod,data,model) (:mod:`repro_torch.launch.specs`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]
AxisRules = Dict[str, Axis]

_STATE = threading.local()


class MeshView(NamedTuple):
    """What the rules read of a mesh: its axis names, in mesh order, and
    each axis's size."""
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]


def mesh_view(mesh: Any) -> MeshView:
    """A torch ``DeviceMesh`` (``mesh_dim_names``, ``shape``) as a
    :class:`MeshView`; any other mesh that has ``axis_names`` and a name
    -> size ``shape`` is taken as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshView(tuple(names), dict(zip(names, mesh.shape)))
    return mesh


def default_rules(mesh: Any, *, fsdp: bool = False,
                  batch_axes: Optional[Tuple[str, ...]] = None,
                  kv_seq_axes: Optional[Tuple[str, ...]] = None,
                  moe_shard: str = "fsdp",
                  layout: str = "dp") -> AxisRules:
    """moe_shard: 'fsdp' (expert weights ZeRO-sharded over data, gathered
    at use), '2d' (expert hidden dim over data x model: local expert
    compute, partial-sum reduction on the down-projection) or 'ep' (experts
    over the data axis).

    layout: 'dp' (batch over data, weights FSDP+TP) or '2dtp' (inference:
    tensor parallelism over (data, model), batch replicated, the KV cache
    still batch-sharded)."""
    names = mesh_view(mesh).axis_names
    data_axes = tuple(a for a in names if a in ("pod", "data"))
    if batch_axes is None:
        batch_axes = data_axes
    if kv_seq_axes is None:
        kv_seq_axes = ("model",)
    fsdp_axis = "data" if fsdp and "data" in names else None
    rules = {
        "batch": batch_axes or None,
        "tp": "model",
        "fsdp": fsdp_axis,
        "kv_seq": kv_seq_axes,
        "kv_batch": batch_axes or None,
        "expert": None,
        "e_in": fsdp_axis,
        "e_out": "model",
        "seq": None,
        "vocab": "model",
    }
    if moe_shard == "2d":
        rules["e_in"] = None
        rules["e_out"] = tuple(a for a in ("data", "model") if a in names)
    elif moe_shard == "ep":
        # experts over the data axis; needs num_experts % data == 0, else
        # sanitize_spec leaves the dim replicated
        rules["expert"] = "data"
        rules["e_in"] = None
        rules["e_out"] = "model"
    if layout == "2dtp":
        tp2 = tuple(a for a in ("data", "model") if a in names)
        rules.update({
            "batch": None,
            "tp": tp2,
            "fsdp": None,
            "vocab": tp2,
            "kv_batch": ("data",) if "data" in names else None,
            "e_in": None,
            "e_out": tp2 if moe_shard == "2d" else "model",
        })
    return rules


@contextlib.contextmanager
def use_sharding(mesh: Any, rules: AxisRules):
    """Make ``mesh`` (a ``DeviceMesh``) and ``rules`` this thread's active
    sharding for :func:`constrain` until the block ends."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def current_mesh() -> Any:
    ctx = getattr(_STATE, "ctx", None)
    return ctx[0] if ctx else None


def current_sharding() -> Optional[Tuple[Any, AxisRules]]:
    """This thread's active (mesh, rules), or None: what a function that may
    run on another thread (a checkpointed group recomputed in the backward
    pass) re-enters with :func:`use_sharding`."""
    return getattr(_STATE, "ctx", None)


def _resolve(spec: Tuple[Optional[str], ...], rules: AxisRules) -> Spec:
    return tuple(None if ax is None else rules.get(ax, None) for ax in spec)


def _axes(axes: Axis) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh: Any, axes: Axis) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]
    return n


def sanitize_spec(spec: Spec, shape: Tuple[int, ...], mesh: Any) -> Spec:
    """Make a spec legal for this (shape, mesh), one entry per dim:
    * drop mesh axes from dims they don't divide (an uneven split is
      refused, e.g. vocab 50280 on a 16-way axis);
    * drop mesh axes already used by an earlier dim (a mesh axis maps to at
      most one dim) — earlier dims win."""
    mesh = mesh_view(mesh)
    out = []
    used = set()
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, axes in zip(shape, spec):
        if axes is not None:
            tup = tuple(a for a in _axes(axes) if a not in used)
            axes = (None if not tup
                    else tup[0] if len(tup) == 1 else tup)
        if axes is not None and dim % _axis_size(mesh, axes) != 0:
            axes = None
        if axes is not None:
            used.update(_axes(axes))
        out.append(axes)
    return tuple(out)


def placements(spec: Spec, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` for the tensor dim ``d`` that names the mesh axis, else
    ``Replicate()``.  A dim split over a tuple of axes gets ``Shard(d)`` on
    each of them; DTensor splits over mesh dims in mesh order, so the
    tuple must name them in that order (the first one major, as the
    reference's specs do)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_view(mesh).axis_names
    owner = {}
    for d, axes in enumerate(spec):
        tup = _axes(axes)
        if list(tup) != sorted(tup, key=names.index):
            raise ValueError(f"axes {tup} of dim {d} are not in the mesh's "
                             f"order {names}")
        for a in tup:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards dims {owner[a]} "
                                 f"and {d}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (False at once for a plain tensor, so
    single-device code pays no import).  Whatever the thread: the autograd
    engine runs a backward pass on threads of its own."""
    if x is None or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: Any, *logical: Optional[str]) -> Any:
    """Lay ``x`` out as its logical axis names (one per dim; None = not
    sharded) say under the active rules: a DTensor is redistributed to the
    sanitised spec's placements (a partial sum is reduced).  ``x`` comes
    back unchanged with no active mesh or when it is not a DTensor."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    want = placements(sanitize_spec(_resolve(tuple(logical), rules),
                                    tuple(x.shape), mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def replicated_call(fn, args: tuple, n_out: int):
    """``fn(*args)``; over DTensors (under an active mesh) on whole
    tensors, every input gathered and every one of the ``n_out`` tensor
    results replicated (``local_map``): for host-shaped index work whose
    ops DTensor's versions do not all cover (the MoE routing's top-k,
    cumsum and index writes)."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    full = [Replicate()] * mesh.ndim
    return local_map(
        fn, out_placements=tuple([full] * n_out) if n_out > 1 else full,
        in_placements=tuple(full if is_dtensor(a) else None for a in args),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def gather(x: Any, *dims: int) -> Any:
    """A DTensor ``x`` with ``dims`` replicated (the mesh dims splitting
    them gathered), the rest kept; anything else unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims
                 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def reshape(x: Any, *shape: int) -> Any:
    """``x.reshape(*shape)``.  A DTensor whose first reshaped dim is
    sharded over more ranks than the new dim there divides (14 heads out
    of a 16-way split of ``H * D``: DTensor refuses the uneven split) is
    first replicated over those mesh dims, as XLA reshards."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate, Shard
    new = list(shape)
    if -1 in new:
        rest = 1
        for n in new:
            rest *= n if n != -1 else 1
        new[new.index(-1)] = x.numel() // rest
    k = 0
    while k < min(x.dim(), len(new)) and x.shape[k] == new[k]:
        k += 1
    sizes = x.device_mesh.shape
    split = 1
    for p, n in zip(x.placements, sizes):
        if isinstance(p, Shard) and p.dim == k:
            split *= n
    want = tuple(
        Replicate() if isinstance(p, Shard) and p.dim >= k and (
            p.dim > k or k >= len(new) or new[k] % split) else p
        for p in x.placements)
    if want != tuple(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return x.reshape(*shape)


# --------------------------------------------------------------------------- #
# parameter shardings (by leaf name)
# --------------------------------------------------------------------------- #
# leaf-name -> logical spec for the *trailing* dims (leading stack dims of
# grouped layers get None prepended)
_PARAM_TABLE: Dict[str, Tuple[Optional[str], ...]] = {
    # attention / mlp projections [D, out] or [out, D]
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "bq": ("tp",),
    "bk": ("tp",),
    "bv": ("tp",),
    # embeddings: V over fsdp only, D unsharded
    "embed": ("fsdp", None),
    "lm_head": ("fsdp", "vocab"),
    # MoE: stacked expert weights [E, D, F] / [E, F, D]
    "we_gate": ("expert", "e_in", "e_out"),
    "we_up": ("expert", "e_in", "e_out"),
    "we_down": ("expert", "e_out", "e_in"),
    "router": (None, None),
    # SSM
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "a_log": ("tp",),
    "d_skip": ("tp",),
    "dt_bias": ("tp",),
    "ssm_norm": ("tp",),
    # VLM / audio frontends
    "vision_proj": (None, "fsdp"),
    "audio_proj": (None, "fsdp"),
    "xgate_attn": (),
    "xgate_ffn": (),
    # decode-cache leaves (cache_shardings reuses the same table)
    "k": ("kv_batch", "kv_seq", None, None),
    "v": ("kv_batch", "kv_seq", None, None),
    "xk": ("kv_batch", None, None, None),
    "xv": ("kv_batch", None, None, None),
    "conv": ("kv_batch", None, "tp"),
    "state": ("kv_batch", "tp", None, None),
}


def _spec_for_leaf(path: Tuple[Any, ...], ndim: int, rules: AxisRules) -> Spec:
    """The spec of the leaf at ``path`` (dict keys and list indices from the
    root): its last key's table entry for the trailing dims, None for the
    leading ones; a name not in the table (norms, the step counter) is
    replicated."""
    name = next((k for k in reversed(path) if isinstance(k, str)), None)
    base = _PARAM_TABLE.get(name, ()) if name is not None else ()
    extra = ndim - len(base)
    return _resolve((None,) * max(extra, 0) + base[max(-extra, 0):], rules)


def _map_with_path(fn, tree: Any, path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_shardings(params: Any, mesh: Any, rules: AxisRules) -> Any:
    """A tree of specs matching ``params`` (tensors of any device, meta
    ones too), each sanitised against its leaf's shape."""
    return _map_with_path(
        lambda path, leaf: sanitize_spec(
            _spec_for_leaf(path, leaf.dim(), rules), tuple(leaf.shape), mesh),
        params)


# cache_shardings is param_shardings applied to a decode-cache tree — the
# table above carries the cache leaf names ('k','v','xk','xv','conv','state')
cache_shardings = param_shardings


def replicated(tree: Any, mesh: Any) -> Any:
    return _map_with_path(lambda path, leaf: (), tree)


def batch_sharding(tree: Any, mesh: Any, rules: AxisRules) -> Any:
    """Shard dim 0 of every leaf by the 'batch' rule, the rest replicated."""
    return _map_with_path(
        lambda path, x: sanitize_spec(
            _resolve(("batch",) + (None,) * (x.dim() - 1), rules),
            tuple(x.shape), mesh),
        tree)
