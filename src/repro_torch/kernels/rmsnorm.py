"""Row-wise RMS normalisation: the hand-written CUDA kernel
(``csrc/rmsnorm.cu``) and its plain PyTorch version.

A kernel of the port's own (the reference computes ``rmsnorm`` in plain
jnp, ``src/repro/models/layers.py``), written for one property: a row's
result depends on that row alone, never on how many rows the call holds.
PyTorch's ``mean`` over the last axis sums in an order chosen from the
whole tensor's shape, so on the card the same row normalised inside a
verify round (40 rows) and a decode step (8 rows) differed in the last bit.
The kernel runs one block per row with the block size fixed, and sums each
row in one fixed order (see the source).  Bound by bytes.

:func:`rmsnorm_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`rmsnorm_plain` serves CPU tensors, the
tests and the on-card comparison in ``chip_smoke.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import check_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` in float32, cast to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as ``[rows, D]`` without a copy: any contiguous tensor, or a 2-D
    one whose last axis is contiguous (a strided row view)."""
    if x.is_contiguous():
        return x.view(-1, x.shape[-1])
    if x.dim() == 2 and x.stride(1) == 1:
        return x
    raise ValueError(f"rmsnorm_cuda takes a contiguous tensor or a 2-D one "
                     f"with a contiguous last axis, got shape "
                     f"{tuple(x.shape)} strides {x.stride()}")


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream: ``x [..., D]`` in
    float32 or bfloat16, ``w [D]`` contiguous in either; the output has
    x's shape and dtype."""
    check_device((x, w), "rmsnorm_cuda")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x and w, got "
                         f"{x.dtype}/{w.dtype}")
    d = x.shape[-1]
    if w.dim() != 1 or w.shape[0] != d or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [{d}], got shape "
                         f"{tuple(w.shape)} strides {w.stride()}")
    x2 = _rows(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y2 = out.view(-1, d)
    launch, lib = build.load("rmsnorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = launch(x2.data_ptr(), w.data_ptr(), y2.data_ptr(), x2.shape[0], d,
                  _DTYPES[x.dtype], _DTYPES[w.dtype], x2.stride(0),
                  y2.stride(0), float(eps), stream)
    build.check(lib, code, "rmsnorm")
    build.count_launch(rmsnorm_cuda)
    return out


rmsnorm_cuda.launches = 0
