"""Per-(architecture x input-shape) step functions and meta-tensor input
specs for the multi-pod dry-run (:mod:`repro_torch.launch.dryrun`), the
port of the reference's ``launch/specs.py``.  Nothing is allocated here:
the arguments are meta tensors (the counterpart of ``ShapeDtypeStruct``),
and the in and out shardings are trees of specs
(:mod:`repro_torch.distributed.sharding`) over a mesh the caller gives.

Input shapes:
    train_4k      seq=4096    global_batch=256   -> train_step
    prefill_32k   seq=32768   global_batch=32    -> prefill_step
    decode_32k    seq=32768   global_batch=128   -> serve_step (1 new token)
    long_500k     seq=524288  global_batch=1     -> serve_step

``long_500k`` decode semantics per family: native for ssm/hybrid (state /
full cache), a sliding-window (8192) cache for the full-attention
families."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.distributed.sharding import (AxisRules, _map_with_path,
                                              batch_sharding, cache_shardings,
                                              default_rules, mesh_view,
                                              param_shardings, sanitize_spec)
from repro_torch.models.model import Model, cache_shapes
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import make_train_step

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

LONG_WINDOW = 8192          # sliding window for full-attention archs @ 500k
FSDP_THRESHOLD = 4e9        # params above this get weight sharding over data
METRICS = ("loss", "lm_loss", "aux_loss", "lr", "grad_norm")


@dataclasses.dataclass
class StepSpec:
    """``fn(*args)``; ``in_shardings(mesh, rules)`` a tuple of spec trees
    matching ``args``, ``out_shardings(mesh, rules)`` one matching the
    result; ``donate_argnums`` the arguments whose tensors the step
    updates in place (the reference donates them)."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Callable[[Any, AxisRules], Tuple[Any, ...]]
    out_shardings: Optional[Callable[[Any, AxisRules], Any]]
    donate_argnums: Tuple[int, ...]
    notes: str = ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _logits_sharding(mesh, rules, batch, vocab):
    return sanitize_spec((rules.get("batch"), rules.get("vocab")),
                         (batch, vocab), mesh)


def default_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > FSDP_THRESHOLD


def shape_rules(cfg: ModelConfig, shape_name: str, mesh: Any, *,
                fsdp: Optional[bool] = None, moe_shard: str = "fsdp",
                layout: str = "dp") -> AxisRules:
    fsdp = default_fsdp(cfg) if fsdp is None else fsdp
    names = mesh_view(mesh).axis_names
    data_axes = tuple(a for a in names if a in ("pod", "data"))
    if shape_name == "long_500k":
        # batch=1: nothing to data-parallel — spread the KV sequence over
        # every axis instead (context parallelism)
        return default_rules(mesh, fsdp=fsdp, batch_axes=(),
                             kv_seq_axes=data_axes + ("model",),
                             moe_shard=moe_shard, layout=layout)
    return default_rules(mesh, fsdp=fsdp, moe_shard=moe_shard, layout=layout)


def _media_specs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    out = {}
    if cfg.vision is not None:
        out["image_embeds"] = _sds(
            (batch, cfg.vision.num_image_tokens, cfg.vision.embed_dim),
            "bfloat16")
    if cfg.audio is not None:
        out["audio_frames"] = _sds(
            (batch, cfg.audio.num_frames, cfg.audio.embed_dim), "bfloat16")
    return out


def _ctx_len(cfg: ModelConfig) -> int:
    if cfg.vision is not None:
        return cfg.vision.num_image_tokens
    if cfg.audio is not None:
        return cfg.audio.num_frames
    return 0


def _decode_geometry(cfg: ModelConfig, shape_name: str) -> Tuple[int, int]:
    """(cache_len, window) for serve_step."""
    seq = SHAPES[shape_name]["seq"]
    if shape_name == "long_500k" and not cfg.supports_long_context_natively:
        return LONG_WINDOW, LONG_WINDOW
    if cfg.family == "ssm":
        return 8, 0                      # no attention layers: cache is tiny
    return seq, cfg.sliding_window


def build_step_spec(cfg: ModelConfig, shape_name: str, *,
                    attn_schedule: str = "full",
                    unroll_scan: bool = False,
                    microbatches: int = 1,
                    microbatch_unroll: bool = False) -> StepSpec:
    """The step of ``shape_name``'s kind over meta arguments.
    ``unroll_scan`` and ``microbatch_unroll`` are taken for the reference's
    signature and change nothing: the port's layer groups and microbatches
    are Python loops either way."""
    info = SHAPES[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    model = Model(cfg)

    if kind == "train":
        params = model.init_shapes()
        state = {"params": params, "opt": init_opt_state(params)}
        batch_spec = {
            "tokens": _sds((batch, seq), "int32"),
            "labels": _sds((batch, seq), "int32"),
            "mask": _sds((batch, seq), "float32"),
            **_media_specs(cfg, batch),
        }
        step = make_train_step(cfg, attn_schedule=attn_schedule, remat=True,
                               unroll_scan=unroll_scan,
                               microbatches=microbatches).tensors

        def in_sh(mesh, rules):
            ps = param_shardings(state["params"], mesh, rules)
            opt = {"m": param_shardings(state["opt"]["m"], mesh, rules),
                   "v": param_shardings(state["opt"]["v"], mesh, rules),
                   "step": ()}
            return ({"params": ps, "opt": opt},
                    batch_sharding(batch_spec, mesh, rules))

        def out_sh(mesh, rules):
            state_sh, _ = in_sh(mesh, rules)
            return (state_sh, {m: () for m in METRICS})

        return StepSpec("train_step", step, (state, batch_spec),
                        in_sh, out_sh, donate_argnums=(0,))

    params_shapes = model.init_shapes()
    ctx = _ctx_len(cfg)

    if kind == "prefill":
        cache = cache_shapes(cfg, batch, seq, ctx_len=ctx)
        media = _media_specs(cfg, batch)

        def prefill_step(params, tokens, cache, media):
            out = model.apply(params, tokens, mode="prefill", cache=cache,
                              attn_schedule=attn_schedule,
                              logits_mode="last", unroll_scan=unroll_scan,
                              **media)
            return out.logits[:, 0], out.cache

        args = (params_shapes, _sds((batch, seq), "int32"), cache, media)

        def in_sh(mesh, rules):
            return (param_shardings(params_shapes, mesh, rules),
                    batch_sharding(args[1], mesh, rules),
                    cache_shardings(cache, mesh, rules),
                    batch_sharding(media, mesh, rules))

        def out_sh(mesh, rules):
            return (_logits_sharding(mesh, rules, batch, cfg.vocab_size),
                    cache_shardings(cache, mesh, rules))

        return StepSpec("prefill_step", prefill_step, args, in_sh, out_sh,
                        donate_argnums=(2,))

    # decode
    cache_len, window = _decode_geometry(cfg, shape_name)
    cache = cache_shapes(cfg, batch, cache_len, ctx_len=ctx)

    def serve_step(params, cache, tokens, positions):
        out = model.apply(params, tokens, mode="decode", positions=positions,
                          cache=cache, window=window,
                          unroll_scan=unroll_scan)
        return out.logits[:, 0], out.cache

    args = (params_shapes, cache, _sds((batch, 1), "int32"),
            _sds((batch, 1), "int32"))

    def in_sh(mesh, rules):
        return (param_shardings(params_shapes, mesh, rules),
                cache_shardings(cache, mesh, rules),
                batch_sharding(args[2], mesh, rules),
                batch_sharding(args[3], mesh, rules))

    def out_sh(mesh, rules):
        return (_logits_sharding(mesh, rules, batch, cfg.vocab_size),
                cache_shardings(cache, mesh, rules))

    notes = ""
    if shape_name == "long_500k" and not cfg.supports_long_context_natively:
        notes = (f"sliding-window {LONG_WINDOW} cache (full attention cannot "
                 "serve 524k natively)")
    return StepSpec("serve_step", serve_step, args, in_sh, out_sh,
                    donate_argnums=(1,), notes=notes)


def materialize(args: Any, generator: torch.Generator, device,
                high: int) -> Any:
    """A step's meta arguments as real tensors on ``device``, drawn from
    ``generator``: integer leaves (token ids, labels, positions) uniform in
    ``[0, high)``, the batch's ``mask`` ones, the optimizer state (under
    ``opt``) and the caches' ``state``/``conv`` zeros, every other float
    leaf (params, media, KV cells) normal with std 0.02."""
    def fill(path, t):
        if not t.dtype.is_floating_point:
            return torch.randint(0, high, tuple(t.shape), generator=generator,
                                 device=generator.device).to(t.dtype).to(device)
        if "opt" in path or path[-1] in ("state", "conv"):
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        if path[-1] == "mask":
            return torch.ones(t.shape, dtype=t.dtype, device=device)
        return (torch.randn(tuple(t.shape), generator=generator,
                            device=generator.device) * 0.02
                ).to(t.dtype).to(device)

    return _map_with_path(fill, args)
