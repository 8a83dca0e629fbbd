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
:func:`tensor_core_tile` asks the library which tensor-core tile (if any)
takes the inputs, :func:`plan_k_splits` is the wrapper's split of K on that
tile, and :func:`quant_matmul_split_plain` mirrors that split-K arithmetic
for the CPU tests (nothing on a serving path calls it).
:func:`quantize_kv_int8` is the int8 KV pages' quantiser
(:class:`repro_torch.core.paged_kv.PagedKVPool`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import check_device, sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 8        # the grid a decode plan aims at (the K-split
                         # sweep on the H100, PERF.md)
MIN_SPLIT_STEPS = 4      # the fewest BK steps a split of K holds


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


def plan_k_splits(m: int, k: int, n: int, sm_count: int,
                  tile: Tuple[int, int, int, int]) -> int:
    """Splits of K for the tensor-core kernel on ``tile`` (BM, BN, BK,
    bytes-bound: :func:`tensor_core_tile`).  The bytes-bound decode tile
    splits until the grid holds :data:`BLOCKS_PER_SM` blocks per SM; the
    prefill tile only until the output tiles and splits fill every SM
    once.  No split holds fewer than :data:`MIN_SPLIT_STEPS` K steps (one
    split when K is shorter)."""
    bm, bn, bk, bytes_bound = tile
    tiles = -(-m // bm) * -(-n // bn)
    target = (BLOCKS_PER_SM if bytes_bound else 1) * sm_count
    want = -(-target // tiles)
    return max(1, min(want, -(-k // bk) // MIN_SPLIT_STEPS))


def k_split_bounds(k: int, n_splits: int, bk: int) -> list:
    """The kernel's K rows of each split: whole BK steps, balanced,
    ``[i*T//n * bk, (i+1)*T//n * bk)`` of ``T = ceil(k / bk)`` steps, cut
    at ``k``."""
    steps = -(-k // bk)
    return [(min(k, i * steps // n_splits * bk),
             min(k, (i + 1) * steps // n_splits * bk))
            for i in range(n_splits)]


def quant_matmul_split_plain(x: torch.Tensor, w_q: torch.Tensor,
                             scales: torch.Tensor, n_splits: int,
                             bk: int) -> torch.Tensor:
    """The tensor-core kernel's split-K arithmetic in torch: each split's
    K rows (:func:`k_split_bounds` on K steps of ``bk``, the tile's BK)
    summed in float32, the partials added in split order, then the scales
    once."""
    total = torch.zeros((x.shape[0], w_q.shape[1]))
    for lo, hi in k_split_bounds(x.shape[1], n_splits, bk):
        total = total + x[:, lo:hi].float() @ w_q[lo:hi].float()
    return (total * scales.float()[None, :]).to(x.dtype)


def _vec(w_q: torch.Tensor) -> int:
    """1 when the rows of ``w_q`` are whole 16-byte chunks, 16-byte
    aligned."""
    return int(w_q.shape[1] % 16 == 0 and w_q.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def _tile(m: int, k: int, dtype: int, vec: int,
          x_aligned: int) -> Optional[Tuple[int, int, int, int]]:
    _, lib = build.load("quant_matmul")
    fn = lib.quant_matmul_tile
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    tile = (ctypes.c_int * 4)()
    return tuple(tile) if fn(m, k, dtype, vec, x_aligned, tile) else None


def tensor_core_tile(x: torch.Tensor, w_q: torch.Tensor
                     ) -> Optional[Tuple[int, int, int, int]]:
    """(BM, BN, BK, bytes-bound) of the tensor-core tile the library takes
    for these inputs, or None when they take the CUDA cores.  The library
    alone makes the choice (``quant_matmul.cu`` ``choose``); the answer is
    cached by what it depends on."""
    return _tile(x.shape[0], x.shape[1], _DTYPES[x.dtype], _vec(w_q),
                 int(x.data_ptr() % 16 == 0))


def planned_splits(x: torch.Tensor, w_q: torch.Tensor) -> int:
    """The wrapper's splits of K for these inputs: :func:`plan_k_splits`
    on the library's tile, 1 on the CUDA cores."""
    tile = tensor_core_tile(x, w_q)
    return 1 if tile is None else plan_k_splits(
        x.shape[0], x.shape[1], w_q.shape[1], sm_count(x.device), tile)


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
    x's dtype.  bf16 x takes the tensor cores where
    :func:`tensor_core_tile` finds a tile, with K split by
    :func:`planned_splits` (and the splits' sum as a second kernel);
    everything else the CUDA cores, rows of ``w_q`` read 16 bytes at a
    time when ``N`` is a multiple of 16 and ``w_q`` is 16-byte aligned,
    element by element otherwise."""
    _check(x, w_q, scales)
    out = _launch(x, w_q, scales, planned_splits(x, w_q))
    build.count_launch(quant_matmul_cuda)
    return out


def _launch(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
            n_splits: int) -> torch.Tensor:
    """The C entry point on checked inputs with ``n_splits`` splits of K
    (tensor-core path only; 1 elsewhere).  The card tests also call it with
    other counts."""
    launch, lib = build.load("quant_matmul")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = None if n_splits == 1 else torch.empty(
        (n_splits, m, n), dtype=torch.float32, device=x.device)
    vec = _vec(w_q)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = launch(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), None if part is None else part.data_ptr(),
                  m, k, n, _DTYPES[x.dtype], vec, n_splits, stream)
    build.check(lib, code, "quant_matmul")
    return out


quant_matmul_cuda.launches = 0
