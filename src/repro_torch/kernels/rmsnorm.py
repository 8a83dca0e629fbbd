"""Row-wise RMS normalisation: the hand-written CUDA kernel
(``csrc/rmsnorm.cu``) and its plain PyTorch version.

A kernel of the port's own (the reference computes ``rmsnorm`` in plain
jnp, ``src/repro/models/layers.py``), written for one property: a row's
result depends on that row alone, never on how many rows the call holds.
PyTorch's ``mean`` over the last axis sums in an order chosen from the
whole tensor's shape, so on the card the same row normalised inside a
verify round (40 rows) and a decode step (8 rows) differed in the last bit.
The kernel sums each row in one order fixed by D alone (one warp a row
at the decode widths, one block a row for wide rows; see the source) and
reads each row once.  Bound by bytes; at the decode shapes a call costs
its host path, which takes one test on the common case.

:func:`rmsnorm_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`rmsnorm_plain` serves CPU tensors, the
tests and the on-card comparison in ``chip_smoke.py``.  Training's
gradient is :func:`rmsnorm_bwd_plain`, plain torch on every device (the
reference differentiates its plain-jnp rmsnorm; no kernel stands behind
it).
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import check_device

MAX_CHUNKS = 8192   # 16-byte chunks a row (csrc/rmsnorm.cu kMaxChunks)
# (x dtype, w dtype) -> (the C entry's dtype-pair code, the widest row)
_KINDS = {(torch.float32, torch.float32): (0, MAX_CHUNKS * 4),
          (torch.float32, torch.bfloat16): (1, MAX_CHUNKS * 4),
          (torch.bfloat16, torch.float32): (2, MAX_CHUNKS * 8),
          (torch.bfloat16, torch.bfloat16): (3, MAX_CHUNKS * 8)}
# csrc/rmsnorm.cu RmsnormArgs: x, w, y, rows, D, dtypes, x_rs, eps, stream
ARGS = struct.Struct("@PPPqqqqfP")
_pack = ARGS.pack
_empty_like = torch.empty_like
# resolved at first use: the C entry point, its library, and torch's
# current-device and raw current-stream getters (CUDA builds only)
_launch = _lib = _device = _raw_stream = None


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` in float32, cast to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5):
    """(dx, dw) of :func:`rmsnorm_plain` for the output gradient ``dy``,
    in float32, cast to x's and w's dtypes: with ``r = rsqrt(mean(x^2) +
    eps)``, ``xhat = x r`` and ``gw = dy w``, ``dx = r (gw - xhat
    mean(gw xhat))`` and ``dw`` the sum over rows of ``dy xhat`` (one
    ``sum`` over the row axis: a fixed order for a given shape)."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    g = dy.float()
    dw = (g * xhat).reshape(-1, x.shape[-1]).sum(0)
    gw = g * w.float()
    dx = r * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw.to(w.dtype)


def _resolve():
    """The entry point through a ``PyDLL`` handle of the built library: the
    call keeps the GIL (a launch takes microseconds; releasing and taking
    the GIL back would cost about as much)."""
    global _launch, _lib, _device, _raw_stream
    _, lib = build.load("rmsnorm")
    fn = ctypes.PyDLL(lib._name).rmsnorm_launch
    fn.argtypes, fn.restype = build.SIGNATURES["rmsnorm"][1], ctypes.c_int
    _device = torch._C._cuda_getDevice
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _lib, _launch = lib, fn
    return fn


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
    x's shape and dtype.

    The common case (contiguous CUDA x and w of a known dtype pair, on the
    current device) takes one test and one packed ctypes call; anything
    else, and the first call (which loads the kernel), takes
    :func:`_rmsnorm_checked`, which explains a refusal or launches on a
    strided row view."""
    dev = x.get_device()
    kind = _KINDS.get((x.dtype, w.dtype))
    if kind is None or dev < 0 or _launch is None or w.get_device() != dev \
            or dev != _device() or not x.is_contiguous() \
            or not w.is_contiguous() or w.dim() != 1 \
            or w.shape != x.shape[-1:] or not 0 < w.shape[0] <= kind[1]:
        return _rmsnorm_checked(x, w, eps)
    d = w.shape[0]
    out = _empty_like(x)
    rows = x.numel() // d
    err = _launch(_pack(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                        kind[0], d, eps, _raw_stream(dev)))
    if err:
        build.check(_lib, err, "rmsnorm")
    if rows:
        build.count_launch(rmsnorm_cuda)
    return out


def _rmsnorm_checked(x: torch.Tensor, w: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """:func:`rmsnorm_cuda` off its common case: every check with its
    reason, then the launch over x's rows (a strided 2-D view keeps its row
    stride)."""
    check_device((x, w), "rmsnorm_cuda")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x and w, got "
                         f"{x.dtype}/{w.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if w.dim() != 1 or w.shape[0] != d or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [{d}], got shape "
                         f"{tuple(w.shape)} strides {w.stride()}")
    code, widest = _KINDS[(x.dtype, w.dtype)]
    if not 0 < d <= widest:
        raise ValueError(f"rmsnorm_cuda takes 1 to {widest} columns of "
                         f"{x.dtype}, got {d}")
    x2 = _rows(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = (_launch or _resolve())(_pack(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), x2.shape[0], d, code,
        x2.stride(0), eps, torch.cuda.current_stream(x.device).cuda_stream))
    build.check(_lib, err, "rmsnorm")
    if x2.shape[0]:
        build.count_launch(rmsnorm_cuda)
    return out


rmsnorm_cuda.launches = 0
