"""Layer library of the port: the dense-attention subset of the reference's
``models/layers.py``.

Pure functions over dict params.  Weights keep the reference's ``[in, out]``
layout (``x @ w``), so the weight bridge (``models/convert.py``) copies
leaves without transposing.  Each block runs one of the reference's modes:

  * ``train``   — full sequence, no cache IO;
  * ``prefill`` — full sequence, writes a decode cache; with ``resume=True``
                  it continues from cached tokens at per-row absolute
                  positions with a ``seq_valid`` right-padding mask (the
                  engine's batched, chunked prefill waves);
  * ``decode``  — one token per slot at per-slot positions over a dense
                  ring cache.

Unlike the reference, caches are updated **in place**: a layer writes its
new K/V cells into the tensors of the ``cache`` dict it is given and returns
that dict.  Callers hand in caches they own (the engine's pool, or a wave's
freshly concatenated prefill cache — never a shared zeros tree).  A frozen
decode slot (``slot_active`` False) has its cell rewritten with its old
value, the in-place form of the reference's ``select_cache_slots`` rule.

Branches of the reference not yet ported raise ``NotImplementedError``
naming the ROADMAP port-queue item that brings them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md, port queue: "
        f"{item})")


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #
def _dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return w.to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (per-token absolute positions)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions.float()[..., None] * freqs                     # [B,S,half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP (SwiGLU)
# --------------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> Params:
    return {
        "w_gate": _dense_init(gen, (d_model, d_ff), dtype),
        "w_up": _dense_init(gen, (d_model, d_ff), dtype),
        "w_down": _dense_init(gen, (d_ff, d_model), dtype),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# --------------------------------------------------------------------------- #
# self-attention (GQA, RoPE, optional sliding window)
# --------------------------------------------------------------------------- #
def init_attn(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    p = {
        "ln": torch.ones((d,), dtype=dt, device=dev),
        "wq": _dense_init(gen, (d, h * hd), dt),
        "wk": _dense_init(gen, (d, hkv * hd), dt),
        "wv": _dense_init(gen, (d, hkv * hd), dt),
        "wo": _dense_init(gen, (h * hd, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, -1, h, hd), k.reshape(b, -1, hkv, hd),
            v.reshape(b, -1, hkv, hd))


def apply_self_attn(
    p: Params,
    x: torch.Tensor,                 # [B, S, D]
    *,
    cfg: ModelConfig,
    mode: str,
    positions: torch.Tensor,         # [B, S] int (decode: S=1)
    cache: Optional[Params] = None,  # {'k','v'}: [B, Sc, Hkv, hd], updated in place
    window: int = 0,
    resume: bool = False,            # prefill continues from cached tokens
    seq_valid: Optional[torch.Tensor] = None,    # [B, S] prefix mask
    slot_active: Optional[torch.Tensor] = None,  # [B] live mask (decode)
    page_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    if page_table is not None:
        raise not_ported("paged-KV decode", "paged KV with paged_attention")
    b, s, _ = x.shape
    hn = rmsnorm(x, p["ln"], cfg.rms_eps)
    q, k, v = _qkv(p, hn, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "prefill" and resume:
        # continuation after an earlier prefill chunk: write the new KV at
        # each row's absolute positions (mod the ring), then attend over the
        # whole cache with per-row query positions.  ``seq_valid`` rows
        # write their cells back unchanged, so right-padding leaves no trace
        kc, vc = cache["k"], cache["v"]
        sc = kc.shape[1]
        bidx = torch.arange(b, device=x.device)[:, None]
        slots = (positions % sc).long()                                 # [B,S]
        if seq_valid is not None:
            keep = seq_valid[..., None, None]
            k = torch.where(keep, k, kc[bidx, slots])
            v = torch.where(keep, v, vc[bidx, slots])
        kc[bidx, slots] = k
        vc[bidx, slots] = v
        out = ops.flash_attention(q, kc, vc, causal=True, window=window,
                                  q_positions=positions)
        new_cache = cache
    elif mode == "decode" and s > 1:
        raise not_ported("S > 1 decode (speculative verification)",
                         "speculative decoding")
    elif mode == "decode":
        kc, vc = cache["k"], cache["v"]
        sc = kc.shape[1]
        pos = positions[:, 0]
        slot = (pos % sc).long()                                        # [B]
        bidx = torch.arange(b, device=x.device)
        k1, v1 = k[:, 0], v[:, 0]
        if slot_active is not None:
            # frozen slots rewrite their cell with its old value
            keep = slot_active[:, None, None]
            k1 = torch.where(keep, k1, kc[bidx, slot])
            v1 = torch.where(keep, v1, vc[bidx, slot])
        kc[bidx, slot] = k1
        vc[bidx, slot] = v1
        idx = torch.arange(sc, device=x.device)[None, :]
        valid = (idx <= pos[:, None]) | (pos[:, None] >= sc)            # ring
        out = ops.decode_attention(q[:, 0], kc, vc, valid)[:, None]
        new_cache = cache
    elif mode in ("train", "prefill"):
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        new_cache = None
        if mode == "prefill":
            kc, vc = cache["k"], cache["v"]
            sc = kc.shape[1]
            take = min(s, sc)
            slots = (s - take + torch.arange(take, device=x.device)) % sc
            kc[:, slots] = k[:, s - take:]
            vc[:, slots] = v[:, s - take:]
            new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return x + out @ p["wo"], new_cache


# --------------------------------------------------------------------------- #
# composed layers (one per ModelConfig.layer_kinds entry)
# --------------------------------------------------------------------------- #
def _check_kind(kind: str) -> None:
    if kind == "attn":
        return
    item = {"moe": "MoE", "xattn": "multimodal", "ssm": "SSM",
            "ssm_moe": "SSM"}.get(kind, kind)
    raise not_ported(f"layer kind {kind!r}", item)


def init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig) -> Params:
    _check_kind(kind)
    if cfg.audio is not None or cfg.vision is not None:
        raise not_ported("cross-attention", "multimodal")
    dt = dtype_of(cfg.dtype)
    p: Params = {"attn": init_attn(gen, cfg)}
    if cfg.d_ff > 0:
        p["ffn_ln"] = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def apply_layer(
    p: Params,
    kind: str,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    mode: str,
    positions: torch.Tensor,
    cache: Optional[Params],
    window: int = 0,
    resume: bool = False,
    seq_valid: Optional[torch.Tensor] = None,
    slot_active: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (x, cache); the cache is updated in place."""
    _check_kind(kind)
    x, c = apply_self_attn(p["attn"], x, cfg=cfg, mode=mode,
                           positions=positions, cache=cache, window=window,
                           resume=resume, seq_valid=seq_valid,
                           slot_active=slot_active, page_table=page_table)
    if "ffn" in p:
        x = x + apply_mlp(p["ffn"], rmsnorm(x, p["ffn_ln"], cfg.rms_eps))
    return x, c
