"""Blocked flash attention for prefill and training: the hand-written CUDA
kernels (``csrc/flash_attention.cu``, the forward; ``csrc/
flash_attention_bwd.cu``, the backward) and their plain PyTorch versions.

Replaces the reference's Pallas TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``), widened to the whole
``ops.flash_attention`` contract — causal, sliding window, ``q_offset``,
per-row ``q_positions [B, Sq]`` and per-key ``kv_valid [B, Skv]`` — so the
engine's resume prefill runs the kernel too.  A key at cache index ``kpos``
is live for a query at ``qpos`` iff ``kpos < Skv & kv_valid &
(kpos <= qpos if causal) & (kpos > qpos - window if window)``.  A row with
no live key takes the mean of V over every key, as the reference's
``_flash_jnp`` gives it (all its scores sit at the same floor): the engine's
sliding-window prefill makes such rows once a query passes ``Skv + window -
2`` over the ring.  The kernel yields 0 there and :func:`flash_attention_cuda`
puts the mean in (:func:`fill_dead_rows`).

:func:`flash_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`flash_attention_plain` is the torch
form of the reference's ``_flash_jnp`` and serves CPU tensors, the tests,
and the on-card comparison in ``chip_smoke.py``.

bfloat16 runs on the tensor cores (``wgmma``, K/V by TMA) with the query
heads of one kv head packed into the rows of a tile; float32 runs on the
CUDA cores.  :func:`packed_rows` and :func:`tile_range` mirror the bf16
kernel's row packing and tile skipping so the CPU tests can hold them to
:func:`live_mask`.

The backward (:func:`flash_attention_bwd_cuda`, :func:`flash_attention_bwd_plain`)
takes the training form only — causal or not, a window, GQA, ``q_offset``
0, no ``q_positions`` or ``kv_valid`` — and gives dQ, dK and dV; dK and dV
sum the G query heads of each kv head.  No TPU kernel stands behind it:
``pallas_call`` has no transpose rule, and the reference's gradient is
XLA's autodiff of ``_flash_jnp``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import HEAD_DIMS, check_device
from repro_torch.kernels.ref import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 128     # packed (token, head) rows of a bf16 CTA
TILE_KEYS = 64      # keys of a KV tile


def packed_rows(g: int) -> list:
    """The bf16 kernel's packed tile for query group ``g``: row ``r`` holds
    (token ``r // g``, head ``r % g``) of the tile's tokens and the kv
    head's query heads, for ``r < (TILE_ROWS // g) * g``; the rows past
    that are padding (None)."""
    if not 1 <= g <= TILE_ROWS:
        raise ValueError(f"query group {g} not in 1..{TILE_ROWS}")
    used = (TILE_ROWS // g) * g
    return [(r // g, r % g) if r < used else None for r in range(TILE_ROWS)]


def tile_range(tile_qpos, skv: int, *, causal: bool, window: int) -> range:
    """The KV tiles the kernel visits for a CTA whose query tokens sit at
    ``tile_qpos``: every tile up to the one holding the largest position
    (causal), from the one holding the smallest position's first windowed
    key (window); all tiles otherwise."""
    qmin, qmax = int(min(tile_qpos)), int(max(tile_qpos))
    kt0, kt1 = 0, -(-skv // TILE_KEYS)
    if causal:
        kt1 = min(kt1, 0 if qmax < 0 else qmax // TILE_KEYS + 1)
    if window > 0 and qmin - window + 1 > 0:
        kt0 = (qmin - window + 1) // TILE_KEYS
    return range(kt0, max(kt0, kt1))


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


def dead_rows(qpos: torch.Tensor, skv: int, *, causal: bool, window: int,
              kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, Sq] True where the query at ``qpos [B, Sq]`` has no live key
    (:func:`live_mask` all False), counted from each row's live index range
    ``[qpos - window + 1, qpos]`` (``[0, Skv)`` clipped) and, with
    ``kv_valid``, its prefix sums."""
    lo = (qpos - window + 1).clamp_min(0) if window > 0 else \
        torch.zeros_like(qpos)
    hi = qpos.clamp(max=skv - 1) if causal else torch.full_like(qpos, skv - 1)
    end = (hi + 1).clamp_min(0)
    if kv_valid is None:
        return end - lo <= 0
    cs = torch.nn.functional.pad(kv_valid.int().cumsum(1), (1, 0))
    return (cs.gather(1, end.clamp(max=skv).long())
            - cs.gather(1, lo.clamp(max=skv).long())) <= 0


def fill_dead_rows(out: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
                   *, causal: bool, window: int,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out [B, Sq, H, D]`` with each row that has no live key
    (:func:`dead_rows`) set to the mean of its kv head's V over every key,
    in float32 then ``out``'s dtype: what the plain version gives there."""
    h, hkv = out.shape[2], v.shape[2]
    dead = dead_rows(qpos, v.shape[1], causal=causal, window=window,
                     kv_valid=kv_valid)
    mean = v.float().mean(1).repeat_interleave(h // hkv, dim=1)     # [B,H,D]
    return torch.where(dead[:, :, None, None], mean[:, None].to(out.dtype),
                       out)


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
    if q.dtype == torch.bfloat16 and h // hkv > TILE_ROWS:
        raise ValueError(f"query group {h // hkv} exceeds the bf16 kernel's "
                         f"{TILE_ROWS}-row tile")
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
    build.count_launch(flash_attention_cuda)
    if window > 0:
        # without a window every engine row sees a key (key 0 under causal)
        # or an all-zero context (a text row of a vision model), where the
        # kernel's 0 is the mean
        qpos = q_positions if q_positions is not None else (
            q_offset + torch.arange(sq, device=q.device))[None].expand(b, sq)
        out = fill_dead_rows(out, v, qpos, causal=causal, window=window,
                             kv_valid=kv_valid)
    return out


flash_attention_cuda.launches = 0


# --------------------------------------------------------------------------- #
# the backward (training): dQ, dK, dV
# --------------------------------------------------------------------------- #
def first_dead_row(sq: int, skv: int, *, causal: bool, window: int):
    """The first query row of the training form (``q_offset`` 0, no
    ``q_positions`` or ``kv_valid``) that sees no key, or None.  Row ``i``
    sees ``[max(0, i - window + 1), i]`` (causal) or ``[.., Skv - 1]``,
    clipped to ``[0, Skv)``; its upper end never falls below 0, so only the
    lower end can pass ``Skv - 1``, first at ``i = Skv + window - 1``."""
    if sq and not skv:
        return 0
    if window > 0 and sq - window >= skv:
        return skv + window - 1
    return None


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, *, causal: bool = True,
                              window: int = 0, chunk: int = 1024):
    """(dq, dk, dv) of :func:`flash_attention_plain`'s training form (no
    ``q_positions``, ``kv_valid`` or ``q_offset``), the algorithm of
    ``csrc/flash_attention_bwd.cu`` written out in torch, in float32 over
    KV chunks: each row's log-sum-exp of its scaled live scores and
    ``delta = rowsum(dout * out)``; then per chunk ``P = exp(S - lse)``
    (0 where masked), ``dP = dout V^T``, ``dS = P * (dP - delta)``,
    ``dV = P^T dout``, ``dK = dS^T Q * scale``, ``dQ += dS K * scale``.
    Each gradient comes back in its input's dtype."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    ck = max(1, min(chunk, skv))
    scale = 1.0 / d ** 0.5
    qpos = torch.arange(sq, device=q.device)[None].expand(b, sq)
    qf = q.reshape(b, sq, hkv, g, d).float()
    dof = dout.reshape(b, sq, hkv, g, d).float()
    delta = (dof * out.reshape(b, sq, hkv, g, d).float()).sum(-1) \
        .permute(0, 2, 3, 1)                                  # [B,Hkv,G,Sq]

    def chunk_scores(k0):
        kc = k[:, k0:k0 + ck].float()
        live = torch.ones((b, kc.shape[1]), dtype=torch.bool, device=q.device)
        mask = live_mask(qpos, skv, causal=causal, window=window,
                         kv_valid=live, k_start=k0)[:, None, None]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc) * scale
        return kc, mask, torch.where(mask, s, NEG_INF)

    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    for k0 in range(0, skv, ck):
        _, _, s = chunk_scores(k0)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    lse = m + torch.log(l)

    dq = torch.zeros_like(qf)
    dk = torch.empty((b, skv, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, skv, hkv, d), dtype=v.dtype, device=v.device)
    for k0 in range(0, skv, ck):
        kc, mask, s = chunk_scores(k0)
        vc = v[:, k0:k0 + ck].float()
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vc)
        ds = p * (dp - delta[..., None])
        dv[:, k0:k0 + ck] = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
        dk[:, k0:k0 + ck] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kc)
    return (dq.mul_(scale).reshape(b, sq, h, d).to(q.dtype), dk, dv)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0,
                             q_positions: Optional[torch.Tensor] = None,
                             kv_valid: Optional[torch.Tensor] = None):
    """Launch ``csrc/flash_attention_bwd.cu`` (its pre-pass, dK/dV and dQ
    kernels, one C call) on PyTorch's current stream: (dq, dk, dv) in the
    inputs' dtype.  It takes the training form only and raises on
    ``q_positions``, ``kv_valid``, a ``q_offset`` or a row with no live key
    (:func:`first_dead_row`), never computing those plainly.  Non-contiguous
    inputs are copied contiguous first."""
    if q_positions is not None or kv_valid is not None or q_offset:
        raise ValueError("flash_attention_bwd_cuda takes the training form "
                         "only: no q_positions, kv_valid or q_offset")
    tensors = [t.contiguous() for t in (q, k, v, out, dout)]
    q, k, v, out, dout = tensors
    check_device(tensors, "flash_attention_bwd_cuda")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError("the flash backward takes float32 or bfloat16 "
                         "q/k/v/out/dout of one dtype, got "
                         f"{[str(t.dtype) for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} out {tuple(out.shape)} dout "
                         f"{tuple(dout.shape)}: want [B,Sq,H,D] and "
                         "[B,Skv,Hkv,D]")
    b, sq, h, d = q.shape
    kb, skv, hkv, kd = k.shape
    if kb != b or kd != d or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         "do not agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (want one of "
                         f"{HEAD_DIMS})")
    dead = first_dead_row(sq, skv, causal=causal, window=window)
    if dead is not None:
        raise ValueError(f"query row {dead} sees no key (Skv {skv}, window "
                         f"{window}): the flash backward takes no dead row")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_bwd_cuda needs 16-byte aligned "
                         "tensors")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not b * sq:
        return dq, dk.zero_(), dv.zero_()
    lse, delta = (torch.empty((b, h, sq), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    launch, lib = build.load("flash_attention_bwd")
    code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), b, sq, skv,
                  h, hkv, d, _DTYPES[q.dtype], int(causal), int(window),
                  torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, "flash_attention_bwd")
    build.count_launch(flash_attention_bwd_cuda)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
