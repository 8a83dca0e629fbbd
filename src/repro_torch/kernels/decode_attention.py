"""One-token GQA decode attention: the hand-written CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Replaces the reference's Pallas TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention.py``).  Bound by the K/V bytes it
reads; the kernel splits S across blocks (flash-decoding) and merges the
splits in a second kernel; see the kernel source for the design.

:func:`decode_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`decode_attention_plain` is the torch
form of the reference's ``_decode_jnp`` and serves CPU tensors, the tests,
and the on-card comparison in ``chip_smoke.py``.  :func:`plan_splits` is
the wrapper's choice of splits, and :func:`decode_attention_split_plain`
mirrors the kernel's split-S algorithm for the CPU tests (nothing on the
serving path calls it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
MIN_SPLIT_KEYS = 64      # the least keys a split holds (unless S is smaller)
BLOCKS_PER_SM = 4        # the grid a plan aims at: 2 hide the latency,
                         # 4 measured 7-9 % faster than 2 at the
                         # cross-attention shape and within 0.001 ms of it
                         # at the text one (chip_smoke.py's split sweep,
                         # PERF.md)
TILE_KEYS = 32           # keys a tile inside a split
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SM_COUNT = {}


def plan_splits(s: int, bh: int, sm_count: int) -> int:
    """Splits of S for a grid of ``bh = B * Hkv`` (batch row, kv head)
    pairs: enough for :data:`BLOCKS_PER_SM` blocks per SM, but none shorter
    than :data:`MIN_SPLIT_KEYS` keys (one split when S is shorter)."""
    want = -(-BLOCKS_PER_SM * sm_count // max(bh, 1))
    return max(1, min(want, s // MIN_SPLIT_KEYS))


def split_bounds(s: int, n_splits: int) -> list:
    """The kernel's balanced key ranges ``[i*s//n, (i+1)*s//n)``."""
    return [(i * s // n_splits, (i + 1) * s // n_splits)
            for i in range(n_splits)]


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, kv_valid: torch.Tensor,
                                 n_splits: int) -> torch.Tensor:
    """The kernel's split-S algorithm in plain PyTorch: per split, tiles of
    :data:`TILE_KEYS` keys each scored whole (one max per query row per
    tile, then exp and P V), carried as an unnormalised (m, l, acc); then
    the splits merged in index order with the denominator clamped at 1e-30.
    A split with no live key carries m = NEG_INF, l = 0."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, d).float()
    scale = 1.0 / d ** 0.5
    inf = float("inf")
    parts = []
    for lo, hi in split_bounds(s, n_splits):
        m = torch.full((b, hkv, g), -inf, device=q.device)
        l = torch.zeros((b, hkv, g), device=q.device)
        acc = torch.zeros((b, hkv, g, d), device=q.device)
        for t0 in range(lo, hi, TILE_KEYS):
            t1 = min(t0 + TILE_KEYS, hi)
            live = kv_valid[:, None, None, t0:t1]
            sc = torch.einsum("bhgd,bshd->bhgs", qf,
                              k_cache[:, t0:t1].float()) * scale
            sc = torch.where(live, sc, -inf)
            m_new = torch.maximum(m, sc.amax(-1))
            m_use = torch.where(m_new == -inf, 0.0, m_new)
            p = torch.where(live, torch.exp(sc - m_use[..., None]), 0.0)
            alpha = torch.exp(m - m_use)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgs,bshd->bhgd", p, v_cache[:, t0:t1].float())
            m = m_new
        parts.append((torch.where(m == -inf, NEG_INF, m), l, acc))
    if n_splits == 1:
        out = parts[0][2] / parts[0][1].clamp_min(1e-30)[..., None]
    else:
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num = torch.zeros_like(parts[0][2])
        den = torch.zeros_like(parts[0][1])
        for m, l, acc in parts:
            c = torch.exp(m - mx)
            num = num + acc * c[..., None]
            den = den + l * c
        out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


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


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    if device.index not in _SM_COUNT:
        _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device.index]


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
    if not q.is_contiguous() or not kv_valid.is_contiguous() \
            or q.data_ptr() % 16:
        raise ValueError("q and kv_valid must be contiguous, q 16-byte "
                         "aligned")
    vec = 16 // q.element_size()
    for t in (k_cache, v_cache):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"k/v must have a contiguous head_dim axis, "
                             f"16-byte aligned rows (strides {t.stride()})")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          kv_valid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (and its split combine) on PyTorch's current
    stream.  ``k_cache`` / ``v_cache`` may be strided views (e.g. one layer
    of a stacked ``[L, B, S, Hkv, D]`` cache) as long as head_dim is
    contiguous."""
    _check(q, k_cache, v_cache, kv_valid)
    out = _launch(q, k_cache, v_cache, kv_valid, plan_splits(
        k_cache.shape[1], q.shape[0] * k_cache.shape[2], sm_count(q.device)))
    build.count_launch(decode_attention_cuda)
    return out


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            kv_valid: torch.Tensor, n_splits: int) -> torch.Tensor:
    """The C entry point on checked inputs with ``n_splits`` splits of S
    (the split kernel, then the combine when ``n_splits > 1``).
    ``chip_smoke.py`` also calls it with other counts to time the plan."""
    launch, lib = build.load("decode_attention")
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    part = None if n_splits == 1 else torch.empty(
        (b, hkv, n_splits, h // hkv, d + 2), dtype=torch.float32,
        device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), b, h, hkv, s, d,
        _DTYPES[q.dtype], n_splits, *k_cache.stride()[:3],
        *v_cache.stride()[:3], kv_valid.stride(0), stream)
    build.check(lib, code, "decode_attention")
    return out


decode_attention_cuda.launches = 0
