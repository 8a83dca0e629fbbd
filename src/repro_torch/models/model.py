"""Model builder of the port: the reference's ``models/model.py`` for every
family it serves — dense attention, MoE, vision (gated cross-attention),
Mamba-2 SSM and the Mamba + attention hybrid, and the audio
encoder-decoder.

A model is a dict of params plus ``apply`` in three modes (``train``,
``prefill``, ``decode``).  ``ModelConfig.layer_kinds()`` is factored into
``prefix + pattern x repeats``; the repeated pattern's params are stacked on a
leading axis, exactly as the reference stacks them for ``lax.scan``, and
``apply`` runs a Python loop over the repeats.  Caches keep the same layout
(``block/pos{i}`` leaves ``[repeats, B, S, Hkv, D]``; an ``xattn`` layer's
``xk``/``xv`` leaves ``[repeats, B, ctx_len, Hkv, D]``) and are updated in
place (see :mod:`repro_torch.models.layers`).  A Mamba layer's cache holds
``conv`` ``[.., B, W-1, C]`` in the cache dtype and ``state`` ``[.., B, H,
P, N]`` in float32.  A vision model projects the image embeddings with
``vision_proj`` into the context its cross-attention layers attend to; an
audio model projects its frame embeddings with ``audio_proj`` and runs them
through its encoder stack (``encoder``, then ``enc_ln``), and each decoder
layer's ungated cross-attention reads the result (``xk``/``xv`` over the
``num_frames`` frames).
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import constrain, use_sharding
from repro_torch.distributed.sharding import current_sharding
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


def _layer_dff(cfg: ModelConfig, kind: str) -> Optional[int]:
    """The MLP width of an ``attn`` layer in an MoE model (its dense
    layers, e.g. deepseek's layer 0); None keeps ``cfg.d_ff``."""
    if cfg.moe and kind == "attn" and cfg.moe.dense_d_ff:
        return cfg.moe.dense_d_ff
    return None


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
    """``logits``; ``cache`` (prefill and decode; None in train mode);
    ``aux_loss``, the float32 sum of the MoE blocks' load-balance losses in
    the reference's order (prefix layers, then the repeat groups), 0 for a
    model without MoE.  Training adds it to the loss; serving ignores
    it."""
    logits: torch.Tensor
    cache: Optional[Params]
    aux_loss: torch.Tensor


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
        has_cross = cfg.family == "audio"
        params: Params = {
            "embed": layers._dense_init(generator, (cfg.vocab_size, cfg.d_model), dt),
            "final_ln": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers._dense_init(
                generator, (cfg.d_model, cfg.vocab_size), dt)
        params["prefix_layers"] = [
            layers.init_layer(generator, kind, cfg, d_ff=_layer_dff(cfg, kind),
                              has_cross=has_cross)
            for kind in prefix]
        block: Dict[str, Params] = {}
        for i, kind in enumerate(pattern):
            reps = [layers.init_layer(generator, kind, cfg,
                                      d_ff=_layer_dff(cfg, kind),
                                      has_cross=has_cross)
                    for _ in range(repeats)]
            block[f"pos{i}"] = _stack(reps)
        params["block"] = block
        if cfg.vision is not None:
            params["vision_proj"] = layers._dense_init(
                generator, (cfg.vision.embed_dim, cfg.d_model), dt)
        if cfg.audio is not None:
            params["audio_proj"] = layers._dense_init(
                generator, (cfg.audio.embed_dim, cfg.d_model), dt)
            params["encoder"] = _stack([
                layers.init_layer(generator, "attn", cfg)
                for _ in range(cfg.audio.encoder_layers)])
            params["enc_ln"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
        return tree_map(lambda a: a.to(target), params)

    def init_shapes(self) -> Params:
        """The params as meta tensors (shapes and dtypes, no storage): the
        reference's ``init_shapes``, for the dry-run and the sharding
        rules."""
        return self.init(_META_DRAWS, device="meta")

    def encode_audio(self, params: Params, frames: torch.Tensor,
                     attn_schedule: str = "full") -> torch.Tensor:
        """The reference's ``_encode_audio``: ``frames [B, F, De] @
        audio_proj``, the encoder's ``attn`` layers in ``train`` mode (no
        cache; their flash call is causal, as the reference's is), then
        ``enc_ln``."""
        cfg = self.cfg
        x = frames.to(params["audio_proj"].dtype) @ params["audio_proj"]
        x = constrain(x, "batch", None, None)
        pos = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[:2])
        for g in range(cfg.audio.encoder_layers):
            p = tree_map(lambda a: a[g], params["encoder"])
            x, _, _ = layers.apply_layer(p, "attn", x, cfg=cfg,
                                         mode="train", positions=pos,
                                         cache=None,
                                         attn_schedule=attn_schedule)
        return layers.rmsnorm(x, params["enc_ln"], cfg.rms_eps)

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
        audio_frames: Optional[torch.Tensor] = None,  # [B, F, De]
        cross_cached: bool = False,     # content-cache hit: xk/xv in cache
        ctx_valid: Optional[torch.Tensor] = None,   # [B, T_ctx] media liveness
        remat: bool = False,            # train: recompute each repeat group
        attn_schedule: str = "full",    # ops.flash_attention schedule
        unroll_scan: bool = False,      # the reference's signature only
    ) -> ModelOutput:
        """``last_idx`` (a port addition for the engine's prefill waves)
        takes each row's hidden state at its own last real token before
        the LM head, so a wave never materialises ``[k, bucket, vocab]``
        logits; it yields ``[B, 1, V]`` like ``logits_mode='last'``.

        With ``page_table`` (paged decode), ``cache`` is a paged arena: its
        layers are read and written through the table, and every other
        top-level key (the arena's own ``page_table``) is left untouched.

        Decode takes ``S > 1`` tokens per slot too (speculative
        verification): ``positions [B, S]`` and ``seq_valid [B, S]`` (the
        slot's input and staged drafts) reach the layers as in prefill, and
        the logits are ``[B, S, V]``.

        In train mode ``remat`` wraps each repeat group in
        ``torch.utils.checkpoint.checkpoint`` (non-reentrant), as the
        reference checkpoints its scan body: the group's activations are
        recomputed in the backward pass.  ``attn_schedule`` (``'full'`` or
        ``'causal'``) goes to every train / fresh-prefill self-attention
        call (:func:`repro_torch.kernels.ops.flash_attention`: the causal-
        blocks schedule off the card; on the card the flash kernel already
        skips the KV tiles a causal or windowed row cannot see).
        ``unroll_scan`` is accepted for the reference's signature and
        changes nothing: the groups run as a Python loop."""
        if attn_schedule not in ("full", "causal"):
            raise ValueError(f"unknown attn_schedule {attn_schedule!r}")
        cfg = self.cfg
        b, s = tokens.shape
        window_eff = cfg.sliding_window if window is None else window
        prefix, pattern, repeats = find_pattern(cfg.layer_kinds())
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = constrain(F.embedding(tokens, params["embed"]), "batch", None,
                      None)
        context = None
        if cfg.vision is not None and mode != "decode" and not cross_cached:
            if image_embeds is None:
                raise ValueError("a vision model's prefill needs image_embeds")
            context = image_embeds.to(x.dtype) @ params["vision_proj"]
            context = constrain(context, "batch", None, None)
        if cfg.audio is not None and mode != "decode" and not cross_cached:
            if audio_frames is None:
                raise ValueError("an audio model's prefill needs audio_frames")
            context = self.encode_audio(params, audio_frames, attn_schedule)
        kw = dict(cfg=cfg, mode=mode, positions=positions, window=window_eff,
                  resume=resume, seq_valid=seq_valid, slot_active=slot_active,
                  page_table=page_table, context=context,
                  cross_cached=cross_cached, ctx_valid=ctx_valid,
                  attn_schedule=attn_schedule)

        aux_total = None
        for i, kind in enumerate(prefix):
            sub = cache["prefix"][i] if cache is not None else None
            x, _, aux = layers.apply_layer(params["prefix_layers"][i], kind,
                                           x, cache=sub, **kw)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux

        sharding = current_sharding()

        def group(x, g):
            """Repeat group ``g``: (x, the sum of its MoE losses or None).
            It runs under the caller's sharding wherever it runs (remat
            recomputes it on the autograd engine's thread)."""
            aux_g = None
            with (use_sharding(*sharding) if sharding is not None
                  and current_sharding() is None else nullcontext()):
                for i, kind in enumerate(pattern):
                    p = tree_map(lambda a: a[g], params["block"][f"pos{i}"])
                    sub = (tree_map(lambda a: a[g],
                                    cache["block"][f"pos{i}"])
                           if cache is not None else None)
                    x, _, aux = layers.apply_layer(p, kind, x, cache=sub,
                                                   **kw)
                    if aux is not None:
                        aux_g = aux if aux_g is None else aux_g + aux
            return x, aux_g

        group_aux = []
        for g in range(repeats if pattern else 0):
            if remat and mode == "train":
                # no random op runs in a group: nothing to replay (and a
                # CUDA RNG restore inside DTensor dispatch faults on 2.11)
                x, aux_g = torch.utils.checkpoint.checkpoint(
                    group, x, g, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, aux_g = group(x, g)
            if aux_g is not None:
                group_aux.append(aux_g)
        if group_aux:
            aux_g = torch.stack(group_aux).sum()
            aux_total = aux_g if aux_total is None else aux_total + aux_g
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

        x = layers.rmsnorm(x, params["final_ln"], cfg.rms_eps)
        if last_idx is not None:
            x = x[torch.arange(b, device=x.device), last_idx.long()][:, None]
        elif logits_mode == "last":
            x = x[:, -1:]
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = constrain(x @ head, "batch", None, "vocab")
        return ModelOutput(logits,
                           cache if mode in ("prefill", "decode") else None,
                           aux_total)


class _MetaDraws:
    """Stands in for a generator in :meth:`Model.init_shapes`: every draw
    and constant lands on the meta device."""
    device = torch.device("meta")


_META_DRAWS = _MetaDraws()


def _stack(trees):
    """Stack same-shaped trees leaf by leaf on a new leading axis.  Each
    leaf leaves its source dicts once stacked, so building a stacked
    block holds about one copy of it at a time, not two."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(first)}
    return torch.stack(trees)


# --------------------------------------------------------------------------- #
# decode-cache construction
# --------------------------------------------------------------------------- #
def _layer_cache(cfg: ModelConfig, kind: str, lead: Tuple[int, ...],
                 cache_len: int, ctx_len: int, dtype, device) -> Params:
    """The reference's ``_layer_cache_shape``: a self-attention (``attn`` or
    ``moe``) layer's ring ``k``/``v`` (plus ``xk``/``xv`` over the
    ``ctx_len`` encoder frames in an audio decoder); an ``xattn`` layer's
    ``xk``/``xv`` over the media context; a Mamba layer's ``conv`` (in
    ``dtype``) and ``state`` (float32)."""
    def z(shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    kv = (cfg.num_kv_heads, cfg.head_dim)
    out: Params = {}
    if kind in ("attn", "moe"):
        out["k"], out["v"] = z((cache_len,) + kv), z((cache_len,) + kv)
    if kind == "xattn" or (kind in ("attn", "moe") and cfg.family == "audio"):
        out["xk"], out["xv"] = z((ctx_len,) + kv), z((ctx_len,) + kv)
    if kind in ("ssm", "ssm_moe"):
        _, nheads, d_conv = layers._ssm_dims(cfg)
        out["conv"] = z((cfg.ssm.conv_width - 1, d_conv))
        out["state"] = z((nheads, cfg.ssm.head_dim, cfg.ssm.state_dim),
                         torch.float32)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               ctx_len: int = 0, dtype=None,
               device: DeviceLike = None) -> Params:
    """Zeroed decode cache on ``device`` (``cuda`` unless the caller asks
    for another); ``cache_len`` is the KV ring size, ``ctx_len`` the
    cross-attention context length (image tokens / encoder frames)."""
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


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int, *,
                 ctx_len: int = 0, dtype=None) -> Params:
    """:func:`init_cache` as meta tensors (the reference's
    ``cache_shapes``; the dry-run, no storage)."""
    return init_cache(cfg, batch, cache_len, ctx_len=ctx_len, dtype=dtype,
                      device="meta")
