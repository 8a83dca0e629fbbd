"""One-token GQA decode attention through a page table: the hand-written
CUDA kernel (``csrc/paged_attention.cu``) and its plain PyTorch version.

Replaces the reference's Pallas TPU kernel ``paged_attention_pallas``
(``src/repro/kernels/paged_attention.py``).  Bound by the live K/V bytes it
reads; see the kernel source for the design.

:func:`paged_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`paged_attention_plain` is the torch
form of the reference's CPU path of ``ops.paged_attention`` (gather the
pages, dequantise int8 pages, build the ring mask from the positions, then
the dense decode's plain version) and serves CPU tensors, the tests, and the
on-card comparison in ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (HEAD_DIMS, MAX_GROUP,
                                                  check_device,
                                                  decode_attention_plain)
from repro_torch.kernels.ref import gather_pages, ring_valid

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          positions: torch.Tensor, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Gather each row's pages into a dense ``[B, P*ps, Hkv, D]`` row (int8
    pages times their scales, in float32), mask the cells past each row's
    position (ring semantics), and run the dense decode's plain version."""
    s = page_table.shape[1] * k_pages.shape[1]
    return decode_attention_plain(
        q, gather_pages(k_pages, page_table, k_scale),
        gather_pages(v_pages, page_table, v_scale), ring_valid(positions, s))


def _check(q, k_pages, v_pages, page_table, positions, k_scale, v_scale):
    int8 = k_scale is not None
    tensors = [q, k_pages, v_pages, page_table, positions]
    if int8:
        if v_scale is None:
            raise ValueError("int8 pages need both k_scale and v_scale")
        tensors += [k_scale, v_scale]
    check_device(tensors, "paged_attention_cuda")
    kv_dtype = torch.int8 if int8 else q.dtype
    if q.dtype not in _DTYPES or k_pages.dtype != kv_dtype \
            or v_pages.dtype != kv_dtype:
        raise ValueError(f"paged attention takes float32 or bfloat16 q with "
                         f"pages of q's dtype (or int8 with scales), got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError(f"page_table and positions must be int32, got "
                         f"{page_table.dtype}/{positions.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_pages.shape)} "
                         f"v {tuple(v_pages.shape)}: want [B,H,D] and "
                         f"[N,ps,Hkv,D]")
    b, h, d = q.shape
    n, ps, hkv, kd = k_pages.shape
    if kd != d or h % hkv or page_table.dim() != 2 \
            or page_table.shape[0] != b or positions.shape != (b,):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_pages.shape)} "
                         f"page_table {tuple(page_table.shape)} positions "
                         f"{tuple(positions.shape)} do not agree")
    if d not in HEAD_DIMS or h // hkv > MAX_GROUP:
        raise ValueError(f"head_dim {d} (want one of {HEAD_DIMS}) or query "
                         f"group {h // hkv} (max {MAX_GROUP}) not supported")
    if not q.is_contiguous() or not positions.is_contiguous() \
            or page_table.stride(1) != 1:
        raise ValueError("q, positions and the page-table rows must be "
                         "contiguous")
    vec = 8 if int8 else 16 // q.element_size()
    for t in (k_pages, v_pages):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"pages must have a contiguous head_dim axis and "
                             f"{vec}-element aligned rows (strides "
                             f"{t.stride()})")
    if int8:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != (n, ps, hkv):
                raise ValueError(f"scales must be float32 [N,ps,Hkv] = "
                                 f"{(n, ps, hkv)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         positions: torch.Tensor, *,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  The pages and
    scales may be strided views (one layer of a stacked ``[L, N, ps, Hkv,
    D]`` arena) as long as head_dim is contiguous; nothing is copied."""
    _check(q, k_pages, v_pages, page_table, positions, k_scale, v_scale)
    launch, lib = build.load("paged_attention")
    b, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    int8 = k_scale is not None
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = (k_scale, v_scale) if int8 else (None, None)
    code = launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scales),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        b, h, hkv, page_table.shape[1], ps, d, _DTYPES[q.dtype], int(int8),
        *k_pages.stride()[:3], *v_pages.stride()[:3],
        *(k_scale.stride() if int8 else (0, 0, 0)),
        *(v_scale.stride() if int8 else (0, 0, 0)),
        page_table.stride(0), stream)
    build.check(lib, code, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
