"""Plain-torch oracles for the attention kernels of the port.

These are the *semantic definitions*: naive, O(S^2)-materialising, easy to
audit, and written to the same contract as the reference package's
``kernels/ref.py``.  The tests hold them to the reference on the CPU; the
hand-written CUDA kernels and their plain versions in ``ops.py`` are held to
them in turn.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, H, D] by repeating each kv head H/Hkv times."""
    rep = num_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def flash_attention_ref(
    q: torch.Tensor,                   # [B, Sq, H, D]
    k: torch.Tensor,                   # [B, Skv, Hkv, D]
    v: torch.Tensor,                   # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    window: int = 0,                   # 0 = unlimited; else sliding window
    q_offset: int = 0,                 # global position of q[0]
) -> torch.Tensor:
    """Naive softmax attention oracle (GQA via kv-head repetition)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    k = repeat_kv(k, h).float()
    v = repeat_kv(v, h).float()
    scale = 1.0 / d ** 0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,                   # [B, H, D] one new token per sequence
    k_cache: torch.Tensor,             # [B, S, Hkv, D]
    v_cache: torch.Tensor,             # [B, S, Hkv, D]
    kv_valid: torch.Tensor,            # [B, S] bool — which cache slots live
) -> torch.Tensor:
    """Single-token GQA decode over a (possibly ring-buffered) KV cache."""
    h, d = q.shape[1], q.shape[2]
    k = repeat_kv(k_cache, h).float()
    v = repeat_kv(v_cache, h).float()
    scale = 1.0 / d ** 0.5
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    scores = torch.where(kv_valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v)
    return out.to(q.dtype)


def paged_attention_ref(
    q: torch.Tensor,                   # [B, H, D] one new token per sequence
    k_pages: torch.Tensor,             # [N, ps, Hkv, D] global page arena
    v_pages: torch.Tensor,             # [N, ps, Hkv, D]
    page_table: torch.Tensor,          # [B, P] int page id per table entry
    positions: torch.Tensor,           # [B] int position of the query token
    *,
    k_scale: Optional[torch.Tensor] = None,   # [N, ps, Hkv] f32 (int8 pages)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention through a page table: gather each sequence's pages
    into a contiguous [B, P*ps, Hkv, D] view (dequantising int8 pages with
    their per-(position, head) scales), mask cells past the query position
    (ring semantics: a fully wrapped cache attends to everything), and run
    the dense decode oracle."""
    valid = ring_valid(positions, page_table.shape[1] * k_pages.shape[1])
    return decode_attention_ref(q, gather_pages(k_pages, page_table, k_scale),
                                gather_pages(v_pages, page_table, v_scale),
                                valid)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``pages[page_table]`` as one contiguous ``[B, P*ps, Hkv, D]`` row per
    sequence; int8 pages come back as float32 times their scales."""
    b, p = page_table.shape
    rows = pages[page_table.long()]                   # [B, P, ps, Hkv, D]
    if scale is not None:
        rows = rows.float() * scale[page_table.long()][..., None]
    return rows.reshape(b, p * pages.shape[1], *pages.shape[2:])


def ring_valid(positions: torch.Tensor, s: int) -> torch.Tensor:
    """[B, s] liveness of a ring of ``s`` cells for a query at ``positions``:
    cell ``i`` is live iff ``i <= pos``, or every cell once ``pos >= s``."""
    idx = torch.arange(s, device=positions.device)[None, :]
    pos = positions.long()[:, None]
    return (idx <= pos) | (pos >= s)


def quant_matmul_ref(
    x: torch.Tensor,                   # [M, K] bf16/f32
    w_q: torch.Tensor,                 # [K, N] int8
    scales: torch.Tensor,              # [N] f32 per-output-channel scales
) -> torch.Tensor:
    """int8-weight matmul oracle: dequantise then matmul in f32."""
    w = w_q.float() * scales[None, :].float()
    return (x.float() @ w).to(x.dtype)
