"""One-token GQA decode attention: the hand-written CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Replaces the reference's Pallas TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention.py``).  Bound by the K/V bytes it
reads; see the kernel source for the design.

:func:`decode_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`decode_attention_plain` is the torch
form of the reference's ``_decode_jnp`` and serves CPU tensors, the tests,
and the on-card comparison in ``chip_smoke.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           kv_valid: torch.Tensor) -> torch.Tensor:
    """One-token attention, S as a single contraction (torch form of the
    reference's ``_decode_jnp``): masked scores at NEG_INF, masked
    probabilities forced to 0, denominator clamped at 1e-30."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, d).float()
    scale = 1.0 / d ** 0.5
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float()) * scale
    live = kv_valid[:, None, None, :]
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p / l, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def check_device(tensors, what: str) -> None:
    """Raise unless every tensor lies on the current CUDA device (the
    kernels launch there, on PyTorch's current stream)."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors only")
    dev = torch.cuda.current_device()
    if any(t.device.index != dev for t in tensors):
        raise ValueError(f"{what}: tensors must lie on the current CUDA "
                         f"device cuda:{dev}")


def _check(q, k_cache, v_cache, kv_valid) -> None:
    check_device((q, k_cache, v_cache, kv_valid), "decode_attention_cuda")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}")
    if kv_valid.dtype != torch.bool:
        raise ValueError(f"kv_valid must be bool, got {kv_valid.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)}: want [B,H,D] and "
                         f"[B,S,Hkv,D]")
    b, h, d = q.shape
    kb, s, hkv, kd = k_cache.shape
    if kb != b or kd != d or h % hkv or kv_valid.shape != (b, s):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"kv_valid {tuple(kv_valid.shape)} do not agree")
    if d not in HEAD_DIMS or h // hkv > MAX_GROUP:
        raise ValueError(f"head_dim {d} (want one of {HEAD_DIMS}) or query "
                         f"group {h // hkv} (max {MAX_GROUP}) not supported")
    if not q.is_contiguous() or not kv_valid.is_contiguous():
        raise ValueError("q and kv_valid must be contiguous")
    vec = 16 // q.element_size()
    for t in (k_cache, v_cache):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"k/v must have a contiguous head_dim axis, "
                             f"16-byte aligned rows (strides {t.stride()})")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          kv_valid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  ``k_cache`` /
    ``v_cache`` may be strided views (e.g. one layer of a stacked
    ``[L, B, S, Hkv, D]`` cache) as long as head_dim is contiguous."""
    _check(q, k_cache, v_cache, kv_valid)
    launch, lib = build.load("decode_attention")
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(), b, h, hkv, s, d, _DTYPES[q.dtype],
        *k_cache.stride()[:3], *v_cache.stride()[:3], kv_valid.stride(0),
        stream)
    build.check(lib, code, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0

