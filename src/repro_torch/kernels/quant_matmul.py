"""int8-weight matrix product with per-output-channel scales: the
hand-written CUDA kernel (``csrc/quant_matmul.cu``), its plain PyTorch
version, and the int8 quantisers of the port.

Replaces the reference's Pallas TPU kernel ``quant_matmul_pallas``
(``src/repro/kernels/quant_matmul.py``): ``x [M, K] @ dequant(w_q [K, N])``
with f32 accumulation, the scales ``[N]`` applied once after the sum, and
the output in x's dtype.  Bound by the int8 weight bytes at decode widths
and by the operations at prefill widths; see the kernel source for the
design.  No model of either package calls it: its one entry point is
:func:`repro_torch.kernels.ops.quant_matmul`.

:func:`quant_matmul_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`quant_matmul_plain` computes the kernel's
arithmetic (sum first, then scale) in torch and serves CPU tensors, the
tests, and the on-card comparison in ``chip_smoke.py``.
:func:`quantize_kv_int8` is the int8 KV pages' quantiser
(:class:`repro_torch.core.paged_kv.PagedKVPool`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import check_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantisation of a ``[K, N]``
    weight: ``(int8 [K, N], float32 scales [N])``, scale ``max(absmax,
    1e-8) / 127``, round half to even, clip to +-127 — bit-identical to the
    reference's ``quantize_int8``."""
    wf = w.float()
    scales = wf.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    w_q = torch.round(wf / scales[None, :]).clamp(-127, 127).to(torch.int8)
    return w_q, scales


def quantize_kv_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 quantisation over the LAST axis: ``x``
    ``[..., hd]`` -> ``(int8 [..., hd], float32 scales [...])`` with
    ``dequant = q.float() * scales[..., None]``.  The scale is
    ``max(absmax, 1e-8) / 127``; values round half to even (as JAX's ``round``
    does) and clip to +-127, so the result is bit-identical to the
    reference's."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scales = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scales[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scales


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch: ``(x @ w_q)`` in float32, times the
    scales once after the sum, cast to x's dtype (the reference's
    ``_qmm_kernel`` order; its ``quant_matmul_ref`` scales the weights first
    and so rounds differently, ~1e-6 relative in float32)."""
    return ((x.float() @ w_q.float()) * scales.float()[None, :]).to(x.dtype)


def _check(x, w_q, scales) -> None:
    check_device((x, w_q, scales), "quant_matmul_cuda")
    if x.dtype not in _DTYPES:
        raise ValueError(f"quant_matmul takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"quant_matmul takes int8 w_q and float32 scales, "
                         f"got {w_q.dtype} and {scales.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or scales.dim() != 1 \
            or x.shape[1] != w_q.shape[0] or scales.shape[0] != w_q.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} w_q {tuple(w_q.shape)} "
                         f"scales {tuple(scales.shape)}: want [M, K], "
                         "[K, N], [N]")
    if 0 in x.shape or w_q.shape[1] == 0:
        raise ValueError(f"empty product {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("x, w_q and scales must be contiguous")


def quant_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: ``[M, N]`` in
    x's dtype.  Rows of ``w_q`` are read 16 bytes at a time when ``N`` is a
    multiple of 16 and ``w_q`` is 16-byte aligned, element by element
    otherwise."""
    _check(x, w_q, scales)
    launch, lib = build.load("quant_matmul")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    vec = int(n % 16 == 0 and w_q.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = launch(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), m, k, n, _DTYPES[x.dtype], vec, stream)
    build.check(lib, code, "quant_matmul")
    quant_matmul_cuda.launches += 1
    return out


quant_matmul_cuda.launches = 0
