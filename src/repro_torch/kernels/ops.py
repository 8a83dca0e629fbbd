"""Entry points for the kernels: dispatch by the tensor's device.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
hand-written kernel, which raises on anything it does not take.  There is no
switch and no fallback: a kernel or build failure on the card propagates.

``_flash_plain`` and ``_decode_plain`` are the torch forms of the
reference's ``_flash_jnp`` and ``_decode_jnp``, ``_paged_plain`` that of the
CPU path of its ``paged_attention``, ``_qmm_plain`` the arithmetic of its
``_qmm_kernel``; the kernels themselves live in
:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.decode_attention`,
:mod:`repro_torch.kernels.paged_attention` and
:mod:`repro_torch.kernels.quant_matmul`, each beside its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.quant_matmul import (quant_matmul_cuda,
                                              quant_matmul_plain,
                                              quantize_int8)  # noqa: F401

_flash_plain = flash_attention_plain
_decode_plain = decode_attention_plain
_paged_plain = paged_attention_plain
_qmm_plain = quant_matmul_plain


def flash_attention(
    q: torch.Tensor,                   # [B, Sq, H, D]
    k: torch.Tensor,                   # [B, Skv, Hkv, D]
    v: torch.Tensor,                   # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    q_positions: Optional[torch.Tensor] = None,   # [B, Sq] absolute positions
    kv_valid: Optional[torch.Tensor] = None,      # [B, Skv] liveness mask
) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset,
                                    q_positions=q_positions,
                                    kv_valid=kv_valid)
    return _flash_plain(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, q_positions=q_positions,
                        kv_valid=kv_valid)


def decode_attention(
    q: torch.Tensor,                   # [B, H, D]
    k_cache: torch.Tensor,             # [B, S, Hkv, D]
    v_cache: torch.Tensor,             # [B, S, Hkv, D]
    kv_valid: torch.Tensor,            # [B, S] bool
) -> torch.Tensor:
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, kv_valid)
    return _decode_plain(q, k_cache, v_cache, kv_valid)


def paged_attention(
    q: torch.Tensor,                   # [B, H, D]
    k_pages: torch.Tensor,             # [N, ps, Hkv, D] page arena
    v_pages: torch.Tensor,             # [N, ps, Hkv, D]
    page_table: torch.Tensor,          # [B, P] int32
    positions: torch.Tensor,           # [B] int32 query-token positions
    *,
    k_scale: Optional[torch.Tensor] = None,   # [N, ps, Hkv] f32 (int8 pages)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, page_table,
                                    positions, k_scale=k_scale,
                                    v_scale=v_scale)
    return _paged_plain(q, k_pages, v_pages, page_table, positions,
                        k_scale=k_scale, v_scale=v_scale)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ dequant(w_q [K, N] int8, scales [N])`` in x's dtype
    (pair with :func:`quantize_int8`)."""
    if x.is_cuda:
        return quant_matmul_cuda(x, w_q, scales)
    return _qmm_plain(x, w_q, scales)
