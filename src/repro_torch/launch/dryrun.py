"""Multi-pod dry-run of the port: every (architecture x input-shape x mesh)
combination runs its step once over meta DTensors on a production mesh —
without hardware.

A host tool, like the reference's ``launch/dryrun.py`` (which lowers its
plain jnp paths on CPU placeholder devices): it runs the plain PyTorch
versions of the kernels on meta tensors on torch's fake process group
(:func:`repro_torch.launch.mesh.make_production_mesh`) and never touches a
card.  Per combo this tool:

  1. builds the production mesh (16x16 single-pod or 2x16x16 multi-pod),
  2. resolves the sharding rules (FSDP for >=4B-param models; long_500k
     re-points batch/kv_seq — see launch/specs.py),
  3. lays params, optimizer state, caches and the batch out as meta
     DTensors with the spec's placements and runs the step once under
     ``use_sharding`` and ``implicit_replication()``, then redistributes
     each output to the spec's out sharding (as the reference's
     ``out_shardings`` make XLA do),
  4. counts, per device, from the local operations DTensor runs: FLOPs
     (torch's FLOP formulas on the local shapes), the operand and result
     bytes of every non-view operation (unfused: an upper bound of the
     memory traffic where the reference reads XLA's ``bytes accessed``),
     and the result bytes of every collective by kind (the reference sums
     the collectives of its compiled HLO, which the port has not); the
     argument bytes come from the local shard shapes (the reference reads
     ``memory_analysis``), and whether they fit one card,
  5. derives the three roofline terms (compute / memory / collective)
     against H100 constants, and
  6. writes one JSON record under ``experiments/dryrun_torch/``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict

# NVIDIA H100 SXM5 80GB (data sheet), at its full 700 W power limit
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s, H100 SXM 700 W
HBM_BW = 3.35e12             # HBM3 bytes/s, H100 SXM 700 W
NVLINK_BW = 450e9            # NVLink 4 bytes/s one direction, H100 SXM 700 W
# bytes one H100 80GB HBM3 gives torch (``total_memory``: 79.18 GiB of its
# 80 GiB), what a device's arguments must fit in
CARD_BYTES = int(79.18 * 2**30)
SAVE_DIR = "experiments/dryrun_torch"

_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


# ops that allocate or reinterpret without reading or writing memory
_MOVES_NOTHING = frozenset({"empty", "empty_strided", "empty_like",
                            "new_empty", "new_empty_strided", "_unsafe_view",
                            "detach", "lift_fresh"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def device_counter():
    """A dispatch mode counting what one device runs: it lets DTensor
    desugar each op first (returning ``NotImplemented`` for DTensor ops),
    then sees the local operations and the functional collectives they
    call.  ``flops``, ``bytes`` (operands and results of non-view ops) and
    ``collectives`` (kind -> result bytes)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    class DeviceCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.collectives: Dict[str, int] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            name = packet.__name__
            if name in _COLLECTIVE_KINDS:
                kind = _COLLECTIVE_KINDS[name]
                got = sum(_nbytes(t) for t in tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor))
                self.collectives[kind] = self.collectives.get(kind, 0) + got
                return out
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not (func.is_view or name in _MOVES_NOTHING):
                self.bytes += sum(
                    _nbytes(t) for t in tree_flatten((args, kwargs, out))[0]
                    if isinstance(t, torch.Tensor))
            return out

    return DeviceCounter()


def _local_shape(shape, spec, mesh) -> tuple:
    from repro_torch.distributed.sharding import _axis_size, mesh_view
    view = mesh_view(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _axis_size(view, axes) for n, axes in zip(shape, spec))


def _zip_trees(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts and lists of tensors;
    ``specs`` has the same structure with spec tuples at the leaves."""
    if isinstance(tree, dict):
        return {k: _zip_trees(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_trees(fn, v, s) for v, s in zip(tree, specs)]
    if tree is None:
        return None
    return fn(tree, specs)


def _zip_args(fn, args: tuple, specs: tuple) -> tuple:
    """:func:`_zip_trees` over a step's arguments (or results), a tuple of
    trees."""
    return tuple(_zip_trees(fn, a, s) for a, s in zip(args, specs))


def argument_bytes(args, specs, mesh) -> int:
    """Per-device bytes of ``args`` laid out as ``specs``: each leaf's local
    shard (its spec's divisors of the global shape)."""
    total = []

    def add(leaf, spec):
        n = 1
        for d in _local_shape(tuple(leaf.shape), spec, mesh):
            n *= d
        total.append(n * leaf.element_size())

    _zip_args(add, args, specs)
    return sum(total)


def distribute(args, specs, mesh):
    """``args`` (meta tensors) as DTensors with ``specs``' placements."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import placements
    return _zip_args(
        lambda leaf, spec: distribute_tensor(leaf, mesh,
                                             placements(spec, mesh)),
        args, specs)


def place_outputs(out, specs, mesh):
    """Redistribute each output DTensor (a plain tensor is replicated
    first) to its spec's placements; returns the placed outputs."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed.sharding import placements

    def place(t, spec):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = placements(spec, mesh)
        return t if tuple(t.placements) == want else t.redistribute(mesh, want)

    return _zip_args(place, out, specs)


def _roofline(flops, byts, coll_bytes):
    t = {"compute": flops / PEAK_FLOPS, "memory": byts / HBM_BW,
         "collective": coll_bytes / NVLINK_BW}
    return t, max(t.items(), key=lambda kv: kv[1])[0]


def run_step(spec, mesh, rules) -> Dict[str, Any]:
    """Run ``spec`` once on ``mesh`` under ``rules``: the per-device counts
    of the step and of placing its outputs, the argument and output bytes
    per device, and the placed outputs."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import use_sharding
    from repro_torch.models.model import tree_leaves
    in_specs = spec.in_shardings(mesh, rules)
    out_specs = spec.out_shardings(mesh, rules)
    args = distribute(spec.args, in_specs, mesh)
    counter = device_counter()
    with use_sharding(mesh, rules), implicit_replication(), counter:
        out = spec.fn(*args)
        out = place_outputs(out, out_specs, mesh)
    return {"counter": counter, "out": out, "out_specs": out_specs,
            "argument_bytes": argument_bytes(spec.args, in_specs, mesh),
            "output_bytes": sum(
                _nbytes(t.to_local()) for t in tree_leaves(out))}


def run_combo(arch: str, shape: str, *, multi_pod: bool = False,
              attn_schedule: str = "full", fsdp=None, unroll: bool = False,
              moe_shard: str = "fsdp", layout: str = "dp",
              microbatches: int = 1, microbatch_unroll: bool = False,
              save_dir: str = SAVE_DIR, tag: str = "") -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import SHAPES, build_step_spec, shape_rules

    t0 = time.time()
    cfg = get_config(arch)
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        chips = mesh.size()
        rules = shape_rules(cfg, shape, mesh, fsdp=fsdp,
                            moe_shard=moe_shard, layout=layout)
        spec = build_step_spec(cfg, shape, attn_schedule=attn_schedule,
                               unroll_scan=unroll, microbatches=microbatches,
                               microbatch_unroll=microbatch_unroll)
        res = run_step(spec, mesh, rules)
    counter = res["counter"]
    coll = dict(counter.collectives)
    coll_bytes = sum(coll.values())
    flops, byts = float(counter.flops), float(counter.bytes)
    t, dominant = _roofline(flops, byts, coll_bytes)

    info = SHAPES[shape]
    model_flops = 6 * cfg.active_param_count()
    if info["kind"] == "train":
        model_flops *= info["seq"] * info["batch"] * 3   # fwd + bwd(2x)
    elif info["kind"] == "prefill":
        model_flops *= info["seq"] * info["batch"]
    else:
        model_flops *= info["batch"]
    useful_frac = model_flops / max(flops * chips, 1.0)

    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": int(chips),
        "step": spec.name,
        "attn_schedule": attn_schedule,
        "unrolled": unroll,
        "moe_shard": moe_shard,
        "layout": layout,
        "microbatches": microbatches,
        "fsdp": bool(rules.get("fsdp")),
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": coll_bytes,
        "collectives": coll,
        "t_compute_s": t["compute"],
        "t_memory_s": t["memory"],
        "t_collective_s": t["collective"],
        "dominant": dominant,
        "model_flops_global": model_flops,
        "useful_flop_frac": useful_frac,
        "argument_bytes_per_device": res["argument_bytes"],
        "output_bytes_per_device": res["output_bytes"],
        "fits_card": res["argument_bytes"] <= CARD_BYTES,
        "notes": spec.notes,
        "seconds": time.time() - t0,
        "ok": True,
    }
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(record_path(save_dir, arch, shape, multi_pod, tag),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def record_path(save_dir, arch, shape, multi_pod, tag) -> str:
    suffix = ("_mp" if multi_pod else "") + (f"_{tag}" if tag else "")
    return os.path.join(save_dir, f"{arch}_{shape}{suffix}.json")


ALL_ARCHS = [
    "codeqwen1.5-7b", "deepseek-moe-16b", "yi-34b", "grok-1-314b",
    "llama-3.2-vision-90b", "seamless-m4t-medium", "mamba2-780m",
    "qwen2-0.5b", "glm4-9b", "jamba-1.5-large-398b",
]
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=ALL_SHAPES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attn-schedule", default="full",
                    choices=["full", "causal"])
    ap.add_argument("--fsdp", default=None, choices=["on", "off"])
    ap.add_argument("--unroll", action="store_true",
                    help="taken for the reference's flags: the port's layer "
                         "groups are a Python loop either way")
    ap.add_argument("--moe-shard", default="fsdp", choices=["fsdp", "2d", "ep"])
    ap.add_argument("--layout", default="dp", choices=["dp", "2dtp"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--microbatch-unroll", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-dir", default=SAVE_DIR)
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    combos = ([(a, s) for a in ALL_ARCHS for s in ALL_SHAPES] if args.all
              else [(args.arch, args.shape)])
    fsdp = None if args.fsdp is None else args.fsdp == "on"

    failures = 0
    for arch, shape in combos:
        path = record_path(args.save_dir, arch, shape, args.multi_pod,
                           args.tag)
        if args.skip_done and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    print(f"[skip] {arch} x {shape}")
                    continue
        try:
            rec = run_combo(arch, shape, multi_pod=args.multi_pod,
                            attn_schedule=args.attn_schedule, fsdp=fsdp,
                            unroll=args.unroll, moe_shard=args.moe_shard,
                            layout=args.layout, microbatches=args.microbatch,
                            microbatch_unroll=args.microbatch_unroll,
                            save_dir=args.save_dir, tag=args.tag)
            print(f"[ok]   {arch:24s} {shape:12s} mesh={rec['mesh']} "
                  f"dom={rec['dominant']:10s} "
                  f"t=(c {rec['t_compute_s']:.2e}, m {rec['t_memory_s']:.2e}, "
                  f"x {rec['t_collective_s']:.2e})s "
                  f"args/dev={rec['argument_bytes_per_device'] / 2**30:.2f}GiB "
                  f"run={rec['seconds']:.0f}s", flush=True)
        except Exception as e:                                  # noqa: BLE001
            failures += 1
            print(f"[FAIL] {arch} x {shape}: {e}", flush=True)
            traceback.print_exc()
            if args.save_dir:
                os.makedirs(args.save_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if args.multi_pod
                               else "16x16", "ok": False,
                               "error": f"{type(e).__name__}: {e}"}, f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
