"""Model builder of the port: the reference's ``models/model.py`` for the
dense-attention and vision (gated cross-attention) families.

A model is a dict of params plus ``apply`` in three modes (``train``,
``prefill``, ``decode``).  ``ModelConfig.layer_kinds()`` is factored into
``prefix + pattern x repeats``; the repeated pattern's params are stacked on a
leading axis, exactly as the reference stacks them for ``lax.scan``, and
``apply`` runs a Python loop over the repeats.  Caches keep the same layout
(``block/pos{i}`` leaves ``[repeats, B, S, Hkv, D]``; an ``xattn`` layer's
``xk``/``xv`` leaves ``[repeats, B, ctx_len, Hkv, D]``) and are updated in
place (see :mod:`repro_torch.models.layers`).  A vision model projects the
image embeddings with ``vision_proj`` into the context its cross-attention
layers attend to.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.layers import Params, dtype_of


def find_pattern(kinds: Tuple[str, ...]) -> Tuple[Tuple[str, ...], Tuple[str, ...], int]:
    """Factor ``kinds`` as prefix + pattern*repeats with minimal pattern."""
    n = len(kinds)
    best = (kinds, (), 0)
    best_cost = n
    for plen in range(0, min(n, 4)):
        rest = kinds[plen:]
        m = len(rest)
        for pat in range(1, m + 1):
            if m % pat == 0 and rest == rest[:pat] * (m // pat):
                cost = plen + pat
                if cost < best_cost:
                    best, best_cost = (kinds[:plen], rest[:pat], m // pat), cost
                break
    return best


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of nested dicts/lists (None kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


class ModelOutput(NamedTuple):
    logits: torch.Tensor
    cache: Optional[Params]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
        """Random params on ``device`` (``cuda`` unless the caller asks for
        another; see :func:`repro_torch.device.resolve_device`): the
        reference's shapes and std ``1/sqrt(fan_in)``.  They are drawn from
        ``generator`` on its own device and moved once if that differs.  The
        values differ from the reference's own random draws, so parity tests
        bridge its params instead (:mod:`repro_torch.models.convert`)."""
        target = resolve_device(device)
        cfg = self.cfg
        dt = dtype_of(cfg.dtype)
        dev = generator.device
        prefix, pattern, repeats = find_pattern(cfg.layer_kinds())
        params: Params = {
            "embed": layers._dense_init(generator, (cfg.vocab_size, cfg.d_model), dt),
            "final_ln": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers._dense_init(
                generator, (cfg.d_model, cfg.vocab_size), dt)
        params["prefix_layers"] = [layers.init_layer(generator, kind, cfg)
                                   for kind in prefix]
        block: Dict[str, Params] = {}
        for i, kind in enumerate(pattern):
            reps = [layers.init_layer(generator, kind, cfg)
                    for _ in range(repeats)]
            block[f"pos{i}"] = _stack(reps)
        params["block"] = block
        if cfg.vision is not None:
            params["vision_proj"] = layers._dense_init(
                generator, (cfg.vision.embed_dim, cfg.d_model), dt)
        return tree_map(lambda a: a.to(target), params)

    def apply(
        self,
        params: Params,
        tokens: torch.Tensor,                   # [B, S] int
        *,
        mode: str,                              # train | prefill | decode
        positions: Optional[torch.Tensor] = None,   # [B, S]
        cache: Optional[Params] = None,         # updated in place
        window: Optional[int] = None,
        resume: bool = False,
        seq_valid: Optional[torch.Tensor] = None,   # [B, S] token liveness
        slot_active: Optional[torch.Tensor] = None,  # [B] decode live mask
        logits_mode: str = "full",              # 'full' | 'last'
        last_idx: Optional[torch.Tensor] = None,    # [B]: logits at one row each
        page_table: Optional[torch.Tensor] = None,
        image_embeds: Optional[torch.Tensor] = None,  # [B, T_img, De]
        cross_cached: bool = False,     # content-cache hit: xk/xv in cache
        ctx_valid: Optional[torch.Tensor] = None,   # [B, T_ctx] media liveness
    ) -> ModelOutput:
        """``last_idx`` (a port addition for the engine's prefill waves)
        takes each row's hidden state at its own last real token before
        the LM head, so a wave never materialises ``[k, bucket, vocab]``
        logits; it yields ``[B, 1, V]`` like ``logits_mode='last'``.

        With ``page_table`` (paged decode), ``cache`` is a paged arena: its
        layers are read and written through the table, and every other
        top-level key (the arena's own ``page_table``) is left untouched."""
        cfg = self.cfg
        b, s = tokens.shape
        window_eff = cfg.sliding_window if window is None else window
        prefix, pattern, repeats = find_pattern(cfg.layer_kinds())
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = params["embed"][tokens]
        context = None
        if cfg.vision is not None and mode != "decode" and not cross_cached:
            if image_embeds is None:
                raise ValueError("a vision model's prefill needs image_embeds")
            context = image_embeds.to(x.dtype) @ params["vision_proj"]
        kw = dict(cfg=cfg, mode=mode, positions=positions, window=window_eff,
                  resume=resume, seq_valid=seq_valid, slot_active=slot_active,
                  page_table=page_table, context=context,
                  cross_cached=cross_cached, ctx_valid=ctx_valid)

        for i, kind in enumerate(prefix):
            sub = cache["prefix"][i] if cache is not None else None
            x, _ = layers.apply_layer(params["prefix_layers"][i], kind, x,
                                      cache=sub, **kw)
        for g in range(repeats if pattern else 0):
            for i, kind in enumerate(pattern):
                p = tree_map(lambda a: a[g], params["block"][f"pos{i}"])
                sub = (tree_map(lambda a: a[g], cache["block"][f"pos{i}"])
                       if cache is not None else None)
                x, _ = layers.apply_layer(p, kind, x, cache=sub, **kw)

        x = layers.rmsnorm(x, params["final_ln"], cfg.rms_eps)
        if last_idx is not None:
            x = x[torch.arange(b, device=x.device), last_idx.long()][:, None]
        elif logits_mode == "last":
            x = x[:, -1:]
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = x @ head
        return ModelOutput(logits, cache if mode in ("prefill", "decode") else None)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# --------------------------------------------------------------------------- #
# decode-cache construction
# --------------------------------------------------------------------------- #
def _layer_cache(cfg: ModelConfig, kind: str, lead: Tuple[int, ...],
                 cache_len: int, ctx_len: int, dtype, device) -> Params:
    """A self-attention layer's ring ``k``/``v``; an ``xattn`` layer's
    cross KV ``xk``/``xv`` over the ``ctx_len`` media context."""
    layers._check_kind(kind, cfg)
    names, length = (("xk", "xv"), ctx_len) if kind == "xattn" else \
        (("k", "v"), cache_len)
    shape = lead + (length, cfg.num_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device) for n in names}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               ctx_len: int = 0, dtype=None,
               device: DeviceLike = None) -> Params:
    """Zeroed decode cache on ``device`` (``cuda`` unless the caller asks
    for another); ``cache_len`` is the KV ring size, ``ctx_len`` the
    cross-attention context length (image tokens)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype) if dtype is None else dtype
    prefix, pattern, repeats = find_pattern(cfg.layer_kinds())
    cache: Params = {"prefix": [
        _layer_cache(cfg, kind, (batch,), cache_len, ctx_len, dtype, device)
        for kind in prefix]}
    cache["block"] = {
        f"pos{i}": _layer_cache(cfg, kind, (repeats, batch), cache_len,
                                ctx_len, dtype, device)
        for i, kind in enumerate(pattern)} or None
    return cache
