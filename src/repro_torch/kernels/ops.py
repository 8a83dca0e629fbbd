"""Entry points for the attention kernels: dispatch by the tensor's device.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
hand-written kernel, which raises on anything it does not take.  There is no
switch and no fallback: a kernel or build failure on the card propagates.

``_flash_plain`` and ``_decode_plain`` are the torch forms of the
reference's ``_flash_jnp`` and ``_decode_jnp``; the kernels themselves live
in :mod:`repro_torch.kernels.flash_attention` and
:mod:`repro_torch.kernels.decode_attention`, each beside its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)

_flash_plain = flash_attention_plain
_decode_plain = decode_attention_plain


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
