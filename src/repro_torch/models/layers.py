"""Layer library of the port: every block of the reference's
``models/layers.py`` (attention, MoE, gated and ungated cross-attention,
the Mamba-2 block).

Pure functions over dict params.  Weights keep the reference's ``[in, out]``
layout (``x @ w``), so the weight bridge (``models/convert.py``) copies
leaves without transposing.  Each block runs one of the reference's modes:

  * ``train``   — full sequence, no cache IO;
  * ``prefill`` — full sequence, writes a decode cache; with ``resume=True``
                  it continues from cached tokens at per-row absolute
                  positions with a ``seq_valid`` right-padding mask (the
                  engine's batched, chunked prefill waves);
  * ``decode``  — one token per slot at per-slot positions over a dense
                  ring cache, or (with a ``page_table``) over one layer of
                  the paged arena of :mod:`repro_torch.core.paged_kv`, fp
                  or int8; ``S > 1`` tokens per slot (speculative
                  verification, ``positions [B, S]``, ``seq_valid``) run
                  one decode-kernel call per position.

An ``moe`` layer replaces the MLP with the reference's GShard-style
capacity routing (:func:`apply_moe`): softmax top-k over a float32 router,
a fixed number of slots per expert, pairs past it dropped, shared experts
beside the routed ones.

A gated cross-attention layer (kind ``xattn``, the VLM image layers)
attends to the projected image context: a fresh prefill projects it to
``xk``/``xv`` and writes them into its cache, a content-cache hit
(``cross_cached``) reads them back from the cache instead, and decode reads
them; ``ctx_valid [B, T]`` masks the context slots no image fills.  An
audio decoder's ``attn`` layers carry the same cross-attention to the
encoder output, ungated.

An ``ssm``/``ssm_moe`` layer is the Mamba-2 block (:func:`apply_ssm`): the
causal depthwise conv and the chunked SSD scan of
:func:`repro_torch.kernels.ops.ssd` in prefill, one recurrence step
(:func:`repro_torch.kernels.ops.ssd_decode_step`) in decode, over a cache of
``conv`` (the last W-1 conv inputs) and ``state`` (float32).

Unlike the reference, caches are updated **in place**: a layer writes its
new K/V cells into the tensors of the ``cache`` dict it is given and returns
that dict.  Callers hand in caches they own (the engine's pool, or a wave's
freshly concatenated prefill cache — never a shared zeros tree).  A frozen
decode slot (``slot_active`` False) has its cell rewritten with its old
value, the in-place form of the reference's ``select_cache_slots`` rule; in
a paged arena its write goes to its reserved trash cell instead, as in the
reference.  A Mamba layer rewrites ``conv``/``state`` wholesale, and a
frozen slot's rows are written back with their old values.

Sharding is expressed as in the reference, through
:func:`repro_torch.distributed.constrain` with logical axis names at the
reference's sites (identity with no active mesh or on a plain tensor).
Where the port runs one branch for two of the reference's (decode at S = 1
and S > 1; the output projection after the resume, paged and other
branches), one call serves the sites of both.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.distributed import constrain
from repro_torch.distributed.sharding import (is_dtensor, replicated_call,
                                              reshape)
from repro_torch.kernels import ops
from repro_torch.kernels.quant_matmul import quantize_kv_int8

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #
def _dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    if gen.device.type == "meta":         # shapes only (Model.init_shapes)
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return w.to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Through :func:`repro_torch.kernels.ops.rmsnorm`: the row-invariant
    kernel on the card, the plain version on the CPU."""
    return ops.rmsnorm(x, w, eps)


def rmsnorm_gated(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba-2 gated norm: ``rmsnorm(x * silu(z))``, the gate in float32
    cast to x's dtype, the norm through :func:`rmsnorm`."""
    return rmsnorm(x * F.silu(z.float()).to(x.dtype), w, eps)


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


def write_cells(dst: torch.Tensor, bidx: torch.Tensor, slots: torch.Tensor,
                src: torch.Tensor) -> None:
    """``dst[bidx, slots] = src`` in place: ``dst [B, Sc, ...]``, ``bidx``
    the rows ``[B, 1]``, ``slots [B, S]``, ``src [B, S, ...]``.  Over a
    DTensor (a sharded cache) each position is a masked select of the whole
    ring, which keeps the cache's layout: an index write into a sharded dim
    has no in-place DTensor rule."""
    if not is_dtensor(dst):
        dst[bidx, slots] = src
        return
    cells = torch.arange(dst.shape[1], device=dst.device)[None, :]
    tail = (1,) * (dst.dim() - 2)
    new = dst
    for j in range(slots.shape[1]):
        hit = (cells == slots[:, j:j + 1]).reshape(
            (slots.shape[0], dst.shape[1]) + tail)
        new = torch.where(hit, src[:, j:j + 1], new)
    _copy_into(dst, new)


def write_prefill(dst: torch.Tensor, src: torch.Tensor) -> None:
    """A fresh prefill's ring write, in place: the last ``min(S, Sc)`` of
    ``src [B, S, ...]`` into ``dst [B, Sc, ...]`` at ``pos % Sc``.  Over a
    DTensor it is built whole (the window's tail rolled into place, or the
    prefix beside the ring's untouched cells) and copied in."""
    s, sc = src.shape[1], dst.shape[1]
    take = min(s, sc)
    slots = (s - take + torch.arange(take, device=dst.device)) % sc
    if not is_dtensor(dst):
        dst[:, slots] = src[:, s - take:]
        return
    if take == sc:                          # the window's tail, rotated
        new, shift = src[:, s - sc:], (s - sc) % sc
        if shift:
            new = torch.cat([new[:, sc - shift:], new[:, :sc - shift]], dim=1)
    else:
        new = torch.cat([src, dst[:, take:]], dim=1)
    _copy_into(dst, new)


def _copy_into(dst, new) -> None:
    """``dst.copy_(new)`` for DTensors, ``new`` first laid out as ``dst``
    (an in-place op keeps its destination's placements)."""
    if tuple(new.placements) != tuple(dst.placements):
        new = new.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(new)


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
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = constrain(h, "batch", *((None,) * (h.dim() - 2)), "tp")
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# self-attention (GQA, RoPE, optional sliding window)
# --------------------------------------------------------------------------- #
def init_attn(gen: torch.Generator, cfg: ModelConfig, *,
              cross: bool = False) -> Params:
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
    if cfg.qkv_bias and not cross:
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
    q = reshape(constrain(q, "batch", None, "tp"), b, -1, h, hd)
    k = reshape(constrain(k, "batch", None, "tp"), b, -1, hkv, hd)
    v = reshape(constrain(v, "batch", None, "tp"), b, -1, hkv, hd)
    return q, k, v


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
    page_table: Optional[torch.Tensor] = None,   # [B, P] int32 (paged decode)
    attn_schedule: str = "full",     # train / fresh prefill: ops' schedule
) -> Tuple[torch.Tensor, Optional[Params]]:
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
        write_cells(kc, bidx, slots, k)
        write_cells(vc, bidx, slots, v)
        out = ops.flash_attention(q, kc, vc, causal=True, window=window,
                                  q_positions=positions)
        new_cache = cache
    elif mode == "decode" and page_table is not None:
        # paged KV: the cache holds one layer of the page arena [N, ps, Hkv,
        # hd] and each slot's cells are reached through page_table.  The
        # engine's ensure_decode_capacity makes the write targets pages the
        # slot owns alone; a frozen slot (slot_active False), whose pages
        # may already be freed and handed to another slot, redirects its
        # write to its reserved trash cell (b // ps, b % ps), and so does a
        # speculative cell past the slot's staged drafts (seq_valid False).
        # So the indices of each indexed write below are distinct.
        #
        # S > 1 is speculative verification: for each position j, write
        # cell j, then one paged-attention call for query j (whose live
        # cells end at its own position, so the cells already written for
        # j' > j stay masked).  Row j = 0 is exactly the S = 1 step.
        kc, vc = cache["k"], cache["v"]
        ksc, vsc = cache.get("k_scale"), cache.get("v_scale")
        ps = kc.shape[1]
        bidx = torch.arange(b, device=x.device)
        live = (slot_active if slot_active is not None
                else torch.ones((b,), dtype=torch.bool, device=x.device))
        # the kernel takes contiguous per-position rows: [S, B, ...] copies
        # (no copy at S = 1)
        qs = q.transpose(0, 1).contiguous()
        pos_s = positions.t().contiguous()
        outs = []
        for j in range(s):
            pos = pos_s[j]
            ring = pos % (ps * page_table.shape[1])
            page = page_table[bidx, ring // ps].long()
            off = ring % ps
            ok = live if seq_valid is None else live & seq_valid[:, j]
            page = torch.where(ok, page, bidx // ps)
            off = torch.where(ok, off, bidx % ps)
            pos32 = pos.to(torch.int32)
            if ksc is not None:                         # int8 arena
                kq, ks = quantize_kv_int8(k[:, j])
                vq, vs = quantize_kv_int8(v[:, j])
                kc[page, off], vc[page, off] = kq, vq
                ksc[page, off], vsc[page, off] = ks, vs
                outs.append(ops.paged_attention(qs[j], kc, vc, page_table,
                                                pos32, k_scale=ksc,
                                                v_scale=vsc))
            else:
                kc[page, off], vc[page, off] = k[:, j], v[:, j]
                outs.append(ops.paged_attention(qs[j], kc, vc, page_table,
                                                pos32))
        out = torch.stack(outs, dim=1)
        new_cache = cache
    elif mode == "decode":
        # one token per slot (S = 1), or S > 1 for speculative verification:
        # the S cells are written under the masked-restore rule (a cell of a
        # frozen slot, or past the slot's staged drafts, is rewritten with
        # its old value), then one decode-attention call per position j
        # over the ring up to its own position — never flash, so row j = 0
        # is bit for bit the S = 1 step.  The engine stages no draft for a
        # slot whose ring would wrap inside the round (a wrapped ring's
        # mask is all live, and query j would see the cells of j' > j).
        kc, vc = cache["k"], cache["v"]
        sc = kc.shape[1]
        bidx = torch.arange(b, device=x.device)[:, None]
        slots = (positions % sc).long()                                 # [B,S]
        keep = seq_valid
        if slot_active is not None:
            keep = (slot_active[:, None] if keep is None
                    else keep & slot_active[:, None])
        if keep is not None:
            keep = keep[..., None, None]
            k = torch.where(keep, k, kc[bidx, slots])
            v = torch.where(keep, v, vc[bidx, slots])
        write_cells(kc, bidx, slots, k)
        write_cells(vc, bidx, slots, v)
        kc = constrain(kc, "kv_batch", "kv_seq", None, None)
        vc = constrain(vc, "kv_batch", "kv_seq", None, None)
        idx = torch.arange(sc, device=x.device)[None, :]
        qs = q.transpose(0, 1).contiguous()      # contiguous rows per j
        outs = []
        for j in range(s):
            pos = positions[:, j:j + 1]
            valid = (idx <= pos) | (pos >= sc)                          # ring
            outs.append(ops.decode_attention(qs[j], kc, vc, valid))
        out = torch.stack(outs, dim=1)
        new_cache = cache
    elif mode in ("train", "prefill"):
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  schedule=attn_schedule)
        new_cache = None
        if mode == "prefill":
            # the cache keeps its own layout: the new cells are laid out
            # as it is before the in-place write
            write_prefill(cache["k"], constrain(k, "kv_batch", "kv_seq",
                                                None, None))
            write_prefill(cache["v"], constrain(v, "kv_batch", "kv_seq",
                                                None, None))
            new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    out = constrain(out, "batch", None, "tp")
    return x + out @ p["wo"], new_cache


# --------------------------------------------------------------------------- #
# cross-attention (VLM image layers, gated; audio decoder, ungated)
# --------------------------------------------------------------------------- #
def init_xattn(gen: torch.Generator, cfg: ModelConfig, *,
               gated: bool = True) -> Params:
    """The reference's ``init_xattn``: a gated layer's gate starts at 0, so
    a freshly initialised layer passes its input through unchanged."""
    p = init_attn(gen, cfg, cross=True)
    if gated:
        p["xgate_attn"] = torch.zeros((), dtype=dtype_of(cfg.dtype),
                                      device=gen.device)
    return p


def _gate(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``tanh(gate)`` in float32, in the output's dtype, times ``out``."""
    return torch.tanh(g.float()).to(out.dtype) * out


def apply_cross_attn(
    p: Params,
    x: torch.Tensor,                 # [B, S, D]
    *,
    cfg: ModelConfig,
    mode: str,
    context: Optional[torch.Tensor],  # [B, T, D] image context / encoder out
    cache: Optional[Params] = None,  # {'xk','xv'}: [B, T, Hkv, hd], in place
    cross_cached: bool = False,      # content-cache hit: xk/xv in the cache
    ctx_valid: Optional[torch.Tensor] = None,    # [B, T] context liveness
    gated: bool = True,              # tanh gate (VLM); the audio decoder's
                                     # cross-attention is ungated
) -> Tuple[torch.Tensor, Optional[Params]]:
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    hn = rmsnorm(x, p["ln"], cfg.rms_eps)
    if mode == "prefill" and cross_cached:
        # Alg.3 hit: the layer's cross KV came from the content cache, so
        # the context is not projected again
        q = reshape(hn @ p["wq"], b, s, h, hd)
        out = ops.flash_attention(q, cache["xk"], cache["xv"], causal=False,
                                  kv_valid=ctx_valid)
    elif mode == "decode":
        # S > 1 (speculative verification): the context is the same for
        # every position, so each query j takes one decode call over the
        # shared mask
        xk, xv = cache["xk"], cache["xv"]
        q = reshape(hn @ p["wq"], b, s, h, hd)
        valid = (torch.ones((b, xk.shape[1]), dtype=torch.bool,
                            device=x.device) if ctx_valid is None
                 else ctx_valid)
        qs = q.transpose(0, 1).contiguous()      # contiguous rows per j
        out = torch.stack([ops.decode_attention(qs[j], xk, xv, valid)
                           for j in range(s)], dim=1)
    elif mode in ("train", "prefill"):
        hkv = cfg.num_kv_heads
        q = reshape(hn @ p["wq"], b, s, h, hd)
        xk = reshape(context @ p["wk"], b, -1, hkv, hd)
        xv = reshape(context @ p["wv"], b, -1, hkv, hd)
        out = ops.flash_attention(q, xk, xv, causal=False, kv_valid=ctx_valid)
        if mode == "prefill":
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = constrain(out.reshape(b, s, h * hd), "batch", None, "tp") @ p["wo"]
    return x + (_gate(p["xgate_attn"], out) if gated else out), cache


# --------------------------------------------------------------------------- #
# Mixture of Experts (GShard-style capacity routing)
# --------------------------------------------------------------------------- #
# params kept in float32 whatever ``cfg.dtype``: the reference's MoE router
# and its SSM decay rates, skip weights and step biases
FLOAT32_PARAMS = frozenset({"router", "a_log", "d_skip", "dt_bias"})


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    m = cfg.moe
    d, e = cfg.d_model, m.num_experts
    f = m.expert_d_ff or cfg.d_ff
    dt = dtype_of(cfg.dtype)
    p = {
        "ln": torch.ones((d,), dtype=dt, device=gen.device),
        "router": _dense_init(gen, (d, e), torch.float32),
        "we_gate": _dense_init(gen, (e, d, f), dt, fan_in=d),
        "we_up": _dense_init(gen, (e, d, f), dt, fan_in=d),
        "we_down": _dense_init(gen, (e, f, d), dt, fan_in=f),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d, f * m.num_shared_experts, dt)
    return p


def moe_capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for a call of ``t`` tokens (the static ``B * S``):
    every pair in no-drop mode (``capacity_factor <= 0``), else the
    reference's ``max(8, ceil(t * k / e * capacity_factor))`` in Python
    floats."""
    m = cfg.moe
    if m.capacity_factor <= 0:
        return t * m.experts_per_token
    return max(8, int(math.ceil(t * m.experts_per_token / m.num_experts
                                * m.capacity_factor)))


def moe_route(p: Params, flat: torch.Tensor, cfg: ModelConfig,
              seq_valid: Optional[torch.Tensor] = None):
    """Routing of ``flat [T, D]`` (normed tokens): softmax over the float32
    router, top-k gates renormalised (floor 1e-9), and each (token, choice)
    pair's slot in the ``[E * cap + 1]`` dispatch buffer — its expert times
    ``cap`` plus its rank among the expert's earlier pairs (token-major),
    or the trash slot ``E * cap`` when that rank reaches ``cap`` or the
    token is padding (``seq_valid [T]`` False; padding takes no rank).
    Returns (gates [T, k], slot [T * k], cap, aux), ``aux`` the
    Switch-style load-balance loss from each token's first choice."""
    m = cfg.moe
    t = flat.shape[0]
    e, k = m.num_experts, m.experts_per_token
    cap = moe_capacity(cfg, t)
    probs = torch.softmax(flat.float() @ p["router"], dim=-1)           # [T,E]
    gates, idx = torch.topk(probs, k, dim=-1)                           # [T,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    frac = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * torch.sum(frac * probs.mean(0)) * m.load_balance_coef
    onehot = F.one_hot(idx, e).reshape(t * k, e)
    keep = None
    if seq_valid is not None:
        keep = seq_valid.reshape(t).repeat_interleave(k)                # [T*k]
        onehot = onehot * keep[:, None]
    pos = torch.cumsum(onehot, dim=0) - onehot
    my_pos = torch.sum(pos * onehot, dim=-1)                            # [T*k]
    kept = my_pos < cap if keep is None else (my_pos < cap) & keep
    slot = torch.where(kept, idx.reshape(t * k) * cap + my_pos, e * cap)
    return gates, slot, cap, aux


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              seq_valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (x + y, aux_load_balance_loss), the reference's
    ``apply_moe``: tokens are scattered into ``[E, cap, D]`` expert
    buffers (dropped pairs into a trash row that never reaches an
    expert), the experts' SwiGLU products run as batched matrix products
    over every expert's ``cap`` rows, and each token sums its k outputs
    times their gates in the output dtype, plus the shared experts'
    MLP.  Over DTensors the routing, dispatch and combine run on whole
    tensors (:func:`repro_torch.distributed.sharding.replicated_call`);
    the expert products stay sharded as the rules lay them out."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.experts_per_token
    cap = moe_capacity(cfg, t)
    hn = rmsnorm(x, p["ln"], cfg.rms_eps)
    flat = hn.reshape(t, d)
    valid = None if seq_valid is None else seq_valid.reshape(t)

    def dispatch(flat, router, valid):
        gates, slot, _, aux = moe_route({"router": router}, flat, cfg, valid)
        buf = flat.new_zeros((e * cap + 1, d))
        buf[slot] = flat.repeat_interleave(k, dim=0)
        return buf[:-1].reshape(e, cap, d), gates, slot, aux

    def combine(o, gates, slot):
        obuf = torch.cat([o.reshape(e * cap, d), o.new_zeros((1, d))])
        y = obuf[slot] * gates.reshape(t * k, 1).to(o.dtype)
        return y.reshape(t, k, d).sum(dim=1)

    hbuf, gates, slot, aux = replicated_call(
        dispatch, (flat, p["router"], valid), 4)
    hbuf = constrain(hbuf, "expert", "batch", None)
    h2 = constrain(F.silu(torch.bmm(hbuf, p["we_gate"]))
                   * torch.bmm(hbuf, p["we_up"]), "expert", "batch", "e_out")
    o = constrain(torch.bmm(h2, p["we_down"]), "expert", "batch", None)
    y = replicated_call(combine, (o, gates, slot), 1)
    if "shared" in p:
        # on [B, S, D]: over DTensors a [B * S, D] row split can take the
        # model axis too, which the gradient's unflatten cannot undo
        y = y + apply_mlp(p["shared"], hn).reshape(t, d)
    return x + y.reshape(b, s, d), aux


# --------------------------------------------------------------------------- #
# Mamba-2 block (SSD)
# --------------------------------------------------------------------------- #
def _ssm_dims(cfg: ModelConfig):
    """(d_inner, SSM heads, conv channels) of a Mamba-2 block."""
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    return d_in, d_in // ssm.head_dim, d_in + 2 * ssm.ngroups * ssm.state_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The reference's ``init_ssm``: the decay rates ``a_log``, skip
    weights ``d_skip`` and step biases ``dt_bias`` in float32."""
    ssm = cfg.ssm
    d = cfg.d_model
    d_in, nheads, d_conv = _ssm_dims(cfg)
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    return {
        "ln": torch.ones((d,), dtype=dt, device=dev),
        "in_proj": _dense_init(gen, (d, 2 * d_in + 2 * ssm.ngroups
                                     * ssm.state_dim + nheads), dt),
        "conv_w": _dense_init(gen, (ssm.conv_width, d_conv), dt,
                              fan_in=ssm.conv_width),
        "conv_b": torch.zeros((d_conv,), dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          dtype=torch.float32, device=dev)),
        "d_skip": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "ssm_norm": torch.ones((d_in,), dtype=dt, device=dev),
        "out_proj": _dense_init(gen, (d_in, d), dt),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor],
                 lengths: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d: xbc [B, S, C], w [W, C]; returns (silu(out
    + b), new_state [B, W-1, C], the trailing inputs).  ``lengths`` [B]
    gathers each row's carry window ending at its last *valid* input
    instead of the physical tail, so a right-padded row carries exactly the
    state an unpadded run would."""
    width = w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                             # [B,S+W-1,C]
    s = xbc.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i][None, None]
    if lengths is None:
        new_state = xp[:, xp.shape[1] - (width - 1):]
    else:
        idx = lengths.long()[:, None] + torch.arange(width - 1,
                                                     device=xbc.device)
        new_state = torch.gather(
            xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
    return F.silu(out + b[None, None]), new_state


def apply_ssm(
    p: Params,
    x: torch.Tensor,                 # [B, S, D]
    *,
    cfg: ModelConfig,
    mode: str,
    cache: Optional[Params] = None,  # {'conv': [B,W-1,Dc], 'state': [B,H,P,N]}
    resume: bool = False,            # prefill continues from cached state
    seq_valid: Optional[torch.Tensor] = None,    # [B, S] prefix mask
    slot_active: Optional[torch.Tensor] = None,  # [B] live mask (decode)
) -> Tuple[torch.Tensor, Optional[Params]]:
    """The reference's ``apply_ssm``.  Prefill and decode write the new
    ``conv``/``state`` into ``cache`` in place: a fresh prefill reads
    neither, a resume prefill (``resume``) and decode continue from both.
    ``seq_valid`` turns padded steps into identity updates (``dt = 0``) and
    ends each row's conv carry at its last valid input.  A frozen decode
    slot (``slot_active`` False) keeps both leaves bit for bit, the
    in-place form of the reference's per-slot select of recurrent
    leaves."""
    ssm = cfg.ssm
    b, s, _ = x.shape
    d_in, nheads, d_conv = _ssm_dims(cfg)
    g, n, pdim = ssm.ngroups, ssm.state_dim, ssm.head_dim

    h = rmsnorm(x, p["ln"], cfg.rms_eps)
    zxbcdt = constrain(h @ p["in_proj"], "batch", None, "tp")
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_conv]
    dt = F.softplus(zxbcdt[..., d_in + d_conv:].float()
                    + p["dt_bias"][None, None, :])
    if seq_valid is not None:
        dt = torch.where(seq_valid[..., None], dt, 0.0)
    a = -torch.exp(p["a_log"])

    use_state = mode == "decode" or (mode == "prefill" and resume)
    lengths = seq_valid.sum(-1) if seq_valid is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 cache["conv"] if use_state else None,
                                 lengths=lengths)
    x_ssm = reshape(xbc[..., :d_in], b, s, nheads, pdim)
    b_mat = reshape(xbc[..., d_in:d_in + g * n], b, s, g, n)
    c_mat = reshape(xbc[..., d_in + g * n:], b, s, g, n)

    if mode == "decode":
        y, new_state = ops.ssd_decode_step(
            x_ssm[:, 0], dt[:, 0], a, b_mat[:, 0], c_mat[:, 0],
            cache["state"])
        y = y[:, None]
        if slot_active is not None:
            keep = slot_active[:, None, None]
            new_conv = torch.where(keep, new_conv.to(cache["conv"].dtype),
                                   cache["conv"])
            new_state = torch.where(keep[..., None], new_state,
                                    cache["state"])
    elif mode in ("train", "prefill"):
        y, new_state = ops.ssd(
            x_ssm, dt, a, b_mat, c_mat, chunk=min(ssm.chunk_size, s),
            init_state=cache["state"] if use_state else None)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "train":
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)

    y = y + (p["d_skip"][None, None, :, None] * x_ssm.float()).to(y.dtype)
    y = rmsnorm_gated(y.reshape(b, s, d_in), z, p["ssm_norm"], cfg.rms_eps)
    y = constrain(y, "batch", None, "tp")
    return x + y @ p["out_proj"], cache if mode != "train" else None


# --------------------------------------------------------------------------- #
# composed layers (one per ModelConfig.layer_kinds entry)
# --------------------------------------------------------------------------- #
def init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig, *,
               d_ff: Optional[int] = None, has_cross: bool = False) -> Params:
    """One layer's params, the reference's ``init_layer``: ``attn``/``moe``
    self-attention (plus an ungated cross-attention to the encoder with
    ``has_cross``, the audio decoder), ``xattn`` gated cross-attention,
    ``ssm``/``ssm_moe`` the Mamba-2 block; an ``*moe`` kind's MoE block
    takes the place of the MLP, which the others carry when ``d_ff > 0``
    (``d_ff`` overrides its width: an MoE model's dense layers,
    ``models/model.py:_layer_dff``)."""
    dt = dtype_of(cfg.dtype)
    p: Params = {}
    if kind in ("attn", "moe"):
        p["attn"] = init_attn(gen, cfg)
        if has_cross:
            p["cross"] = init_xattn(gen, cfg, gated=False)
    elif kind == "xattn":
        p["cross"] = init_xattn(gen, cfg)
        p["xgate_ffn"] = torch.zeros((), dtype=dt, device=gen.device)
    elif kind in ("ssm", "ssm_moe"):
        p["ssm"] = init_ssm(gen, cfg)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind.endswith("moe"):
        p["moe"] = init_moe(gen, cfg)
    elif cfg.d_ff > 0:
        p["ffn_ln"] = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
        p["ffn"] = init_mlp(gen, cfg.d_model, d_ff or cfg.d_ff, dt)
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
    context: Optional[torch.Tensor] = None,
    cross_cached: bool = False,
    ctx_valid: Optional[torch.Tensor] = None,
    attn_schedule: str = "full",
) -> Tuple[torch.Tensor, Optional[Params], Optional[torch.Tensor]]:
    """Returns (x, cache, aux); the cache is updated in place.  The blocks
    run in the reference's order: self-attention, the ungated
    cross-attention of an audio decoder layer, the gated one of an
    ``xattn`` layer, the Mamba block, then the MoE or the MLP.  An
    ``xattn`` layer's MLP output is gated like its attention (``tanh`` in
    float32).  ``aux`` is the MoE block's load-balance loss (float32,
    :func:`moe_route`), None for a layer without one; ``Model.apply`` sums
    it into ``ModelOutput.aux_loss``."""
    if "attn" in p:
        x, _ = apply_self_attn(p["attn"], x, cfg=cfg, mode=mode,
                               positions=positions, cache=cache,
                               window=window, resume=resume,
                               seq_valid=seq_valid, slot_active=slot_active,
                               page_table=page_table,
                               attn_schedule=attn_schedule)
    if "cross" in p:
        x, _ = apply_cross_attn(p["cross"], x, cfg=cfg, mode=mode,
                                context=context, cache=cache,
                                cross_cached=cross_cached, ctx_valid=ctx_valid,
                                gated=kind == "xattn")
    if "ssm" in p:
        x, _ = apply_ssm(p["ssm"], x, cfg=cfg, mode=mode, cache=cache,
                         resume=resume, seq_valid=seq_valid,
                         slot_active=slot_active)
    aux = None
    if "moe" in p:
        x, aux = apply_moe(p["moe"], x, cfg, seq_valid=seq_valid)
    elif "ffn" in p:
        out = apply_mlp(p["ffn"], rmsnorm(x, p["ffn_ln"], cfg.rms_eps))
        x = x + (_gate(p["xgate_ffn"], out) if kind == "xattn" else out)
    return x, cache if mode != "train" else None, aux
