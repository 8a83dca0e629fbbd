"""One-token GQA decode attention through a page table: the hand-written
CUDA kernel (``csrc/paged_attention.cu``) and its plain PyTorch version.

Replaces the reference's Pallas TPU kernel ``paged_attention_pallas``
(``src/repro/kernels/paged_attention.py``).  Bound by the live K/V bytes it
reads; the kernel splits each row's live pages across blocks
(flash-decoding) and merges the splits in a second kernel; see the kernel
source for the design.

:func:`paged_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`paged_attention_plain` is the torch
form of the reference's CPU path of ``ops.paged_attention`` (gather the
pages, dequantise int8 pages, build the ring mask from the positions, then
the dense decode's plain version) and serves CPU tensors, the tests, and the
on-card comparison in ``chip_smoke.py``.  :func:`split_cells` and
:func:`paged_attention_split_plain` mirror the kernel's split of a row's
live cells and its tile-by-tile algorithm for the CPU tests (nothing on the
serving path calls them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (HEAD_DIMS, MAX_GROUP,
                                                  TILE_KEYS, check_device,
                                                  decode_attention_plain,
                                                  plan_splits, sm_count)
from repro_torch.kernels.ref import NEG_INF, gather_pages, ring_valid

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


def split_cells(pos: int, total: int, split: int, n_splits: int) -> tuple:
    """The kernel's cells ``[begin, end)`` of split ``split`` of a row whose
    query is at ``pos`` in a table of ``total`` cells: the row's live cells
    (``pos + 1``, or all once the ring has wrapped) in tiles of
    :data:`TILE_KEYS`, whole tiles balanced over the splits."""
    n = total if pos >= total else max(pos + 1, 0)
    nt = -(-n // TILE_KEYS)
    return (min(n, split * nt // n_splits * TILE_KEYS),
            min(n, (split + 1) * nt // n_splits * TILE_KEYS))


def paged_attention_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                positions: torch.Tensor, n_splits: int, *,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: per row, its live cells cut
    by :func:`split_cells`; per split, tiles of :data:`TILE_KEYS` cells read
    through the page table and scored whole (int8: the raw dot times the
    key's scale, then 1/sqrt(D); one max per query row per tile, then exp,
    the row sum, and P times the value scales into P V), carried as an
    unnormalised (m, l, acc); then the splits merged in index order with
    the denominator clamped at 1e-30.  A split with no cell carries
    m = NEG_INF, l = 0."""
    b, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    g = h // hkv
    total = page_table.shape[1] * ps
    scale = 1.0 / d ** 0.5
    out = torch.empty((b, hkv, g, d))
    for row in range(b):
        qf = q[row].reshape(hkv, g, d).float()
        parts = []
        for i in range(n_splits):
            lo, hi = split_cells(int(positions[row]), total, i, n_splits)
            m = torch.full((hkv, g), NEG_INF)
            l = torch.zeros((hkv, g))
            acc = torch.zeros((hkv, g, d))
            for t0 in range(lo, hi, TILE_KEYS):
                cells = torch.arange(t0, min(t0 + TILE_KEYS, hi))
                pages = page_table[row, cells // ps].long()
                off = cells % ps
                k, v = k_pages[pages, off].float(), v_pages[pages, off].float()
                sc = torch.einsum("hgd,shd->hgs", qf, k)
                if k_scale is not None:
                    sc = sc * k_scale[pages, off].T[:, None, :]
                sc = sc * scale
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                if v_scale is not None:
                    p = p * v_scale[pages, off].T[:, None, :]
                acc = acc * alpha[..., None] + torch.einsum("hgs,shd->hgd",
                                                            p, v)
                m = m_new
            parts.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros((hkv, g, d)), torch.zeros((hkv, g))
        for m, l, acc in parts:
            c = torch.exp(m - mx)
            num = num + acc * c[..., None]
            den = den + l * c
        out[row] = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


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
            or page_table.stride(1) != 1 or q.data_ptr() % 16:
        raise ValueError("q, positions and the page-table rows must be "
                         "contiguous, q 16-byte aligned")
    vec = 16 // k_pages.element_size()
    for t in (k_pages, v_pages):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"pages must have a contiguous head_dim axis and "
                             f"16-byte aligned rows (strides {t.stride()})")
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
    """Launch the CUDA kernel (and its split combine) on PyTorch's current
    stream, the splits planned from the table's width, never from the
    positions (which stay on the card).  The pages and scales may be strided
    views (one layer of a stacked ``[L, N, ps, Hkv, D]`` arena) as long as
    head_dim is contiguous; nothing is copied."""
    _check(q, k_pages, v_pages, page_table, positions, k_scale, v_scale)
    n_splits = plan_splits(page_table.shape[1] * k_pages.shape[1],
                           q.shape[0] * k_pages.shape[2], sm_count(q.device))
    out = _launch(q, k_pages, v_pages, page_table, positions, k_scale,
                  v_scale, n_splits)
    build.count_launch(paged_attention_cuda)
    return out


def _launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            page_table: torch.Tensor, positions: torch.Tensor,
            k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
            n_splits: int) -> torch.Tensor:
    """The C entry point on checked inputs with ``n_splits`` splits of each
    row's live cells (the split kernel, then the combine when ``n_splits >
    1``).  ``chip_smoke.py`` and the card tests also call it with other
    counts."""
    launch, lib = build.load("paged_attention")
    b, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    int8 = k_scale is not None
    out = torch.empty_like(q)
    part = None if n_splits == 1 else torch.empty(
        (b, hkv, n_splits, h // hkv, d + 2), dtype=torch.float32,
        device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = (k_scale, v_scale) if int8 else (None, None)
    code = launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scales),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        b, h, hkv, page_table.shape[1], ps, d, _DTYPES[q.dtype], int(int8),
        n_splits, *k_pages.stride()[:3], *v_pages.stride()[:3],
        *(k_scale.stride() if int8 else (0, 0, 0)),
        *(v_scale.stride() if int8 else (0, 0, 0)),
        page_table.stride(0), stream)
    build.check(lib, code, "paged_attention")
    return out


paged_attention_cuda.launches = 0
