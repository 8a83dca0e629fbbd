"""Entry points for the kernels: dispatch by the tensor's device.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
hand-written kernel, which raises on anything it does not take.  There is no
switch and no fallback: a kernel or build failure on the card propagates.

``_flash_plain`` and ``_decode_plain`` are the torch forms of the
reference's ``_flash_jnp`` and ``_decode_jnp``, ``_paged_plain`` that of the
CPU path of its ``paged_attention``, ``_qmm_plain`` the arithmetic of its
``_qmm_kernel``, ``rmsnorm_plain`` the body of its ``rmsnorm`` (a kernel of
the port's own, row-invariant on the card), ``categorical_plain`` its
vmapped ``random.categorical`` of folded step keys (the port's other
own kernel, the sampler's draw).  With grad enabled, attention's training
form and rmsnorm run through the autograd nodes :class:`FlashAttentionFn`
(the backward kernel ``flash_attention_bwd_cuda`` on the card) and
:class:`RmsnormFn`.  The Mamba-2 SSD functions (:func:`ssd`,
:func:`ssd_decode_step`) are the reference's plain-jnp ones in plain torch
on every device: no Pallas kernel stands behind them.  The kernels
themselves live in
:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.decode_attention`,
:mod:`repro_torch.kernels.paged_attention`,
:mod:`repro_torch.kernels.quant_matmul`,
:mod:`repro_torch.kernels.rmsnorm` and
:mod:`repro_torch.kernels.categorical`, each beside its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.categorical import (categorical_cuda,
                                             categorical_plain)
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.quant_matmul import (quant_matmul_cuda,
                                              quant_matmul_plain,
                                              quantize_int8)  # noqa: F401
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_plain, rmsnorm_cuda,
                                         rmsnorm_plain)

_flash_plain = flash_attention_plain
_decode_plain = decode_attention_plain
_paged_plain = paged_attention_plain
_qmm_plain = quant_matmul_plain


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention's training form (no ``q_positions``, ``kv_valid`` or
    ``q_offset``) as an autograd node: ``fwd(q, k, v, causal=, window=,
    return_lse=True)`` gives the output and each row's log-sum-exp, which
    the node saves; ``bwd(q, k, v, out, dout, causal=, window=, lse=)``
    gives (dq, dk, dv) from it.  :func:`flash_attention` passes the kernels
    (``flash_attention_cuda``, ``flash_attention_bwd_cuda``) on the card
    and the plain versions on the CPU; tests pass either pair."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, fwd, bwd):
        out, lse = fwd(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.bwd = causal, window, bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, dout, causal=ctx.causal,
                             window=ctx.window, lse=lse)
        return dq, dk, dv, None, None, None, None


class RmsnormFn(torch.autograd.Function):
    """rmsnorm as an autograd node: ``fwd(x, w, eps)`` gives the output
    (the row-invariant kernel on the card, the plain version on the CPU);
    the backward is :func:`repro_torch.kernels.rmsnorm.rmsnorm_bwd_plain`,
    the float32 formula in torch (the reference's rmsnorm and its
    gradient are plain jnp: no kernel stands behind either)."""

    @staticmethod
    def forward(ctx, x, w, eps, fwd):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return fwd(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_plain(x, w, dy, ctx.eps)
        return dx, dw, None, None


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
    """With grad enabled and an input that requires it, the training form
    runs through :class:`FlashAttentionFn` (the forward and backward
    kernels on the card).  On the card any other form then raises: the
    backward kernel does not take it, and nothing falls back; on the CPU it
    differentiates through the plain version."""
    if _needs_grad(q, k, v):
        train_form = q_positions is None and kv_valid is None and not q_offset
        if train_form:
            fwd, bwd = ((flash_attention_cuda, flash_attention_bwd_cuda)
                        if q.is_cuda else
                        (_flash_plain, flash_attention_bwd_plain))
            return FlashAttentionFn.apply(q, k, v, causal, window, fwd, bwd)
        if q.is_cuda:
            raise ValueError("flash attention with grad takes the training "
                             "form only (no q_positions, kv_valid or "
                             "q_offset): the backward kernel does not take "
                             "this call")
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


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x [..., D] * rsqrt(mean(x^2) + eps) * w [D]`` in float32, cast to
    x's dtype; on the card each row's sum runs in one fixed order whatever
    the number of rows.  With grad enabled and an input that requires it,
    it runs through :class:`RmsnormFn`."""
    if _needs_grad(x, w):
        return RmsnormFn.apply(x, w, eps,
                               rmsnorm_cuda if x.is_cuda else rmsnorm_plain)
    if x.is_cuda:
        return rmsnorm_cuda(x, w, eps)
    return rmsnorm_plain(x, w, eps)


def categorical(logits: torch.Tensor, base_keys, positions,
                salt: Optional[int] = None) -> torch.Tensor:
    """``[B]`` draws from ``softmax(logits [B, V])``: per row the argmax of
    JAX's Gumbel noise under ``fold_in(base_keys, positions)`` (or
    ``fold_in(fold_in(base_keys, salt), positions)``) plus the logits."""
    if logits.is_cuda:
        return categorical_cuda(logits, base_keys, positions, salt)
    return categorical_plain(logits, base_keys, positions, salt)


# --------------------------------------------------------------------------- #
# Mamba-2 SSD (state-space duality): the chunked matmul form
# --------------------------------------------------------------------------- #
# The reference computes these in plain jnp (no ``pallas_call``), so they
# stay plain torch on every device: matrix products and elementwise ops.
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., Q] -> [..., Q, Q]; out[i, j] = sum_{k=j+1..i} x[k], -inf above
    the diagonal (the stable log-space decay matrix of arXiv:2405.21060)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=x.device)
    return seg.masked_fill_(i[:, None] < i[None, :], float("-inf"))


def ssd(
    x: torch.Tensor,                   # [B, S, H, P]
    dt: torch.Tensor,                  # [B, S, H] (already softplus'd, > 0)
    a: torch.Tensor,                   # [H] (negative)
    b_mat: torch.Tensor,               # [B, S, G, N]
    c_mat: torch.Tensor,               # [B, S, G, N]
    *,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N]
    chunk: int = 256,
) -> tuple:
    """Chunked SSD, the reference's ``ssd``: intra-chunk attention-like
    matrix products plus an inter-chunk recurrence over the ``S / Q`` chunk
    states, which emits the state entering each chunk.  Returns (y [B, S,
    H, P] in x's dtype, contiguous; final_state [B, H, P, N] float32).

    The tail is zero-padded to a whole chunk: ``dt = 0`` gives decay
    ``exp(0) = 1`` and a zero input, so padded steps leave the state as it
    is.  Each einsum of the reference runs as explicit products in an
    order that keeps the intermediates small: ``C.B`` per group ``[B, nc,
    G, Q, Q]`` scales the decay matrix in place (the one ``[B, nc, H, Q,
    Q]`` tensor; out of place when an input requires grad), and the chunk states and their read-out contract each
    group's ``rep * P`` columns at once, so no ``[.., Q, Q, H, N]`` or
    ``[.., P, N]``-per-step tensor appears."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, s)
    s_p = -(-s // q) * q
    if s_p != s:
        pad = s_p - s
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc, rep = s_p // q, h // g

    xc = (x * dt[..., None]).float().reshape(bsz, nc, q, h, p) \
        .permute(0, 1, 3, 2, 4)                          # [B,nc,H,Q,P]
    bc = b_mat.float().reshape(bsz, nc, q, g, n).permute(0, 1, 3, 2, 4)
    cc = c_mat.float().reshape(bsz, nc, q, g, n).permute(0, 1, 3, 2, 4)
    dac = (dt.float() * a.float()[None, None, :]).reshape(bsz, nc, q, h) \
        .permute(0, 1, 3, 2)                             # [B,nc,H,Q]
    cs = torch.cumsum(dac, dim=-1)

    # 1) intra-chunk (diagonal blocks): (C.B per group) * L, then @ x; in
    # place when nothing is differentiated (exp's backward reads its result)
    cb = (cc @ bc.transpose(-1, -2))[:, :, :, None]
    if _needs_grad(x, dt, a, b_mat, c_mat,
                   *(() if init_state is None else (init_state,))):
        l_mat = (torch.exp(_segsum(dac)).view(bsz, nc, g, rep, q, q) * cb) \
            .view(bsz, nc, h, q, q)
    else:
        l_mat = _segsum(dac).exp_()                      # [B,nc,H,Q,Q]
        l_mat.view(bsz, nc, g, rep, q, q).mul_(cb)
    y = l_mat @ xc                                       # [B,nc,H,Q,P]
    del l_mat

    # 2) per-chunk output states: (x * decay to the chunk end)^T @ B
    xw = xc * torch.exp(cs[..., -1:] - cs)[..., None]
    xw = xw.view(bsz, nc, g, rep, q, p).permute(0, 1, 2, 3, 5, 4) \
        .reshape(bsz, nc, g, rep * p, q)
    states = (xw @ bc).view(bsz, nc, h, p, n)            # [B,nc,H,P,N]
    del xw

    # 3) inter-chunk recurrence over the nc chunk states
    chunk_decay = torch.exp(cs[..., -1])                 # [B,nc,H]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)                               # entering chunk c
        state = chunk_decay[:, c, :, None, None] * state + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # [B,nc,H,P,N]

    # 4) inter-chunk contribution: C @ (state entering the chunk)^T, decayed
    y_off = cc @ prev_states.view(bsz, nc, g, rep * p, n).transpose(-1, -2)
    y_off = y_off.view(bsz, nc, g, q, rep, p).permute(0, 1, 2, 4, 3, 5) \
        .reshape(bsz, nc, h, q, p) * torch.exp(cs)[..., None]
    y = (y + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, s_p, h, p)
    return y[:, :s].to(x.dtype).contiguous(), state


def ssd_decode_step(
    x: torch.Tensor,                   # [B, H, P] one token
    dt: torch.Tensor,                  # [B, H]
    a: torch.Tensor,                   # [H]
    b_mat: torch.Tensor,               # [B, G, N]
    c_mat: torch.Tensor,               # [B, G, N]
    state: torch.Tensor,               # [B, H, P, N]
) -> tuple:
    """One step of the SSD recurrence (decode): (y [B, H, P] in x's dtype,
    new_state [B, H, P, N] float32)."""
    rep = x.shape[1] // b_mat.shape[1]
    bf = torch.repeat_interleave(b_mat, rep, dim=1).float()
    cf = torch.repeat_interleave(c_mat, rep, dim=1).float()
    dtf = dt.float()
    decay = torch.exp(dtf * a.float()[None, :])[..., None, None]
    upd = (dtf[..., None] * x.float())[..., None] * bf[:, :, None, :]
    new_state = decay * state.float() + upd
    y = (new_state @ cf[..., None])[..., 0]
    return y.to(x.dtype), new_state
