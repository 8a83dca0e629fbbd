"""Blocked flash attention for prefill: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces the reference's Pallas TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``), widened to the whole
``ops.flash_attention`` contract — causal, sliding window, ``q_offset``,
per-row ``q_positions [B, Sq]`` and per-key ``kv_valid [B, Skv]`` — so the
engine's resume prefill runs the kernel too.  A key at cache index ``kpos``
is live for a query at ``qpos`` iff ``kpos < Skv & kv_valid &
(kpos <= qpos if causal) & (kpos > qpos - window if window)``.  Rows with no
live key are outside the contract.

:func:`flash_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`flash_attention_plain` is the torch
form of the reference's ``_flash_jnp`` and serves CPU tensors, the tests,
and the on-card comparison in ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import HEAD_DIMS, check_device
from repro_torch.kernels.ref import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def live_mask(qpos: torch.Tensor, skv: int, *, causal: bool, window: int,
              kv_valid: Optional[torch.Tensor] = None,
              k_start: int = 0) -> torch.Tensor:
    """[B, Sq, Ck] liveness of cache indices ``k_start .. k_start+Ck-1``
    (``Ck = kv_valid.shape[1]`` if given, else ``skv - k_start``) for
    queries at absolute positions ``qpos [B, Sq]``."""
    ck = kv_valid.shape[1] if kv_valid is not None else skv - k_start
    kpos = k_start + torch.arange(ck, device=qpos.device)
    mask = (kpos < skv)[None, None, :].expand(qpos.shape[0], qpos.shape[1], ck)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if window > 0:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0,
                          q_positions: Optional[torch.Tensor] = None,
                          kv_valid: Optional[torch.Tensor] = None,
                          chunk: int = 1024) -> torch.Tensor:
    """Flash-style chunked attention (torch form of the reference's
    ``_flash_jnp``): a loop over KV chunks carrying the running (m, l, acc)
    in f32, so memory stays O(Sq * chunk) per head."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    ck = min(chunk, skv)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    if q_positions is None:
        qpos = (q_offset + torch.arange(sq, device=q.device))[None].expand(b, sq)
    else:
        qpos = q_positions
    qf = q.reshape(b, sq, hkv, g, d).float()
    scale = 1.0 / d ** 0.5
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for k0 in range(0, skv, ck):
        kc = k[:, k0:k0 + ck].float()
        vc = v[:, k0:k0 + ck].float()
        mask = live_mask(qpos, skv, causal=causal, window=window,
                         kv_valid=kv_valid[:, k0:k0 + ck], k_start=k0)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc) * scale
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _check(q, k, v, q_positions, kv_valid) -> None:
    tensors = [q, k, v] + [t for t in (q_positions, kv_valid) if t is not None]
    check_device(tensors, "flash_attention_cuda")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: want [B,Sq,H,D], [B,Skv,Hkv,D]")
    b, sq, h, d = q.shape
    kb, skv, hkv, kd = k.shape
    if kb != b or kd != d or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         "do not agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (want one of "
                         f"{HEAD_DIMS})")
    if q_positions is not None and (q_positions.dtype != torch.int32
                                    or q_positions.shape != (b, sq)
                                    or not q_positions.is_contiguous()):
        raise ValueError("q_positions must be a contiguous int32 [B, Sq]")
    if kv_valid is not None and (kv_valid.dtype != torch.bool
                                 or kv_valid.shape != (b, skv)
                                 or not kv_valid.is_contiguous()):
        raise ValueError("kv_valid must be a contiguous bool [B, Skv]")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    vec = 16 // q.element_size()
    for t in (k, v):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"k/v must have a contiguous head_dim axis and "
                             f"16-byte aligned rows (strides {t.stride()})")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0,
                         q_positions: Optional[torch.Tensor] = None,
                         kv_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  ``k``/``v`` may
    be strided views (one layer of a stacked cache); ``q_positions`` int64
    is narrowed to int32 here."""
    if q_positions is not None and q_positions.dtype == torch.int64:
        q_positions = q_positions.to(torch.int32)
    if q_positions is not None:
        q_positions = q_positions.contiguous()
    _check(q, k, v, q_positions, kv_valid)
    launch, lib = build.load("flash_attention")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if q_positions is None else q_positions.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(),
        b, sq, skv, h, hkv, d, _DTYPES[q.dtype], int(causal), int(window),
        int(q_offset), *k.stride()[:3], *v.stride()[:3], stream)
    build.check(lib, code, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
