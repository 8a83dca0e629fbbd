"""The sampler's draw: JAX's threefry Gumbel noise plus the argmax of
noise + logits in one hand-written CUDA kernel (``csrc/categorical.cu``),
beside its plain PyTorch version.

A kernel of the port's own: the reference draws with JAX's vmapped
``random.categorical`` inside its jitted sampler
(``src/repro/core/sampling.py:168``), which XLA fuses; no TPU kernel stands
behind it.  The plain version runs the threefry functions of
:mod:`repro_torch.core.sampling` (held to JAX's ``random`` module bit for
bit by the CPU tests) as some 140 int64 elementwise passes over ``[B, V]``
words; the kernel keeps the noise in registers and reads each logit once.
Bound by integer operations (see the source).

Per row b: the step key is ``fold_in(base_keys[b], positions[b])``, or
``fold_in(fold_in(base_keys[b], salt), positions[b])`` when a salt is
given, and the draw is ``argmax(gumbel(step key, V) + logits[b])``.

:func:`categorical_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`categorical_plain` serves CPU tensors, the
tests and the on-card comparison in ``chip_smoke.py``; :func:`gumbel_noise`
writes the kernel's noise out, for holding it to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import check_device, sm_count

THREADS = 256          # a block (csrc/categorical.cu kThreads)
# elements a block takes at most: the fastest at [8, 151936] on the H100
# (tools/categorical_chunk_sweep.py; PERF.md has the readings)
MAX_CHUNK = 2048
_entry = None          # (C entry point, library), resolved at first use


def categorical_plain(logits: torch.Tensor, base_keys, positions,
                      salt: Optional[int] = None) -> torch.Tensor:
    """``[B]`` draws from ``softmax(logits [B, V])`` on the per-token
    stream (``salt`` None) or on the ``salt`` stream: exactly what
    ``sampling.categorical`` of ``sampling.fold_step_keys`` /
    ``fold_salted_keys`` computes."""
    # core.sampling routes its draws through kernels.ops: imported here, at
    # call time, so that neither module needs the other to import first
    from repro_torch.core import sampling
    keys = (sampling.fold_step_keys(base_keys, positions) if salt is None
            else sampling.fold_salted_keys(base_keys, salt, positions))
    return sampling.categorical(keys, logits)


def _resolve():
    global _entry
    _entry = build.load("categorical")
    return _entry


def plan_chunk(b: int, v: int, sms: int) -> int:
    """Elements a block takes: the largest of 2048, 1024, 512, 256 that
    still gives the card two blocks an SM (the draws do not depend on it)."""
    chunk = MAX_CHUNK
    while chunk > THREADS and b * -(-v // chunk) < 2 * sms:
        chunk //= 2
    return chunk


def _check(logits, base_keys, positions, what: str) -> None:
    check_device((logits, base_keys, positions), what)
    if logits.dtype != torch.float32 or logits.dim() != 2 \
            or logits.stride(1) != 1:
        raise ValueError(f"{what} takes float32 logits [B, V] with a "
                         f"contiguous last axis, got {logits.dtype} shape "
                         f"{tuple(logits.shape)} strides {logits.stride()}")
    b = logits.shape[0]
    if base_keys.dtype != torch.int64 or positions.dtype != torch.int64:
        raise ValueError(f"{what} takes int64 base_keys and positions, got "
                         f"{base_keys.dtype}/{positions.dtype}")
    if base_keys.shape != (b, 2) or positions.shape != (b,):
        raise ValueError(f"{what}: base_keys {tuple(base_keys.shape)} and "
                         f"positions {tuple(positions.shape)} must be "
                         f"[{b}, 2] and [{b}]")


def _launch(logits, base_keys, positions, salt, out, noise, v,
            chunk) -> None:
    """The C entry point: the draws into ``out`` (``[B]`` followed by the
    blocks' ``B x chunks`` keys), or the noise into ``noise``."""
    launch, lib = _entry or _resolve()
    b = base_keys.shape[0]
    err = launch(
        logits.data_ptr() if logits is not None else None,
        base_keys.data_ptr(), positions.data_ptr(),
        out.data_ptr() if out is not None else None,
        out.data_ptr() + 8 * b if out is not None else None,
        noise.data_ptr() if noise is not None else None,
        b, v, chunk, int(salt is not None),
        0 if salt is None else int(salt) & 0xFFFFFFFF,
        logits.stride(0) if logits is not None else v,
        base_keys.stride(0), base_keys.stride(1), positions.stride(0),
        torch._C._cuda_getCurrentRawStream(base_keys.get_device()))
    if err:
        build.check(lib, err, "categorical")


def categorical_cuda(logits: torch.Tensor, base_keys: torch.Tensor,
                     positions: torch.Tensor, salt: Optional[int] = None,
                     *, chunk: Optional[int] = None) -> torch.Tensor:
    """Launch the draw on PyTorch's current stream: ``logits [B, V]``
    float32 (last axis contiguous), ``base_keys [B, 2]`` and ``positions
    [B]`` int64 on the same card; returns ``[B]`` int64.  ``chunk`` (a
    multiple of 256) overrides the planned elements a block; the draws do
    not depend on it.  No host sync, no host-to-device copy."""
    _check(logits, base_keys, positions, "categorical_cuda")
    b, v = logits.shape
    if chunk is None:
        chunk = plan_chunk(b, v, sm_count(logits.device))
    # the draws and, behind them, the blocks' keys: one allocation
    buf = torch.empty(b * (1 + -(-v // chunk)), dtype=torch.int64,
                      device=logits.device)
    _launch(logits, base_keys, positions, salt, buf, None, v, chunk)
    if b:
        build.count_launch(categorical_cuda)
    return buf[:b]


def gumbel_noise(base_keys: torch.Tensor, positions: torch.Tensor, v: int,
                 salt: Optional[int] = None) -> torch.Tensor:
    """The kernel's Gumbel noise ``[B, v]`` float32 for the same step keys
    (``sampling.gumbel`` of the folded keys on the plain side).  Not on any
    serving path: the noise check of ``chip_smoke.py`` and the card's
    tests."""
    noise = torch.empty((base_keys.shape[0], v), device=base_keys.device)
    _check(noise, base_keys, positions, "gumbel_noise")
    _launch(None, base_keys, positions, salt, None, noise, v,
            plan_chunk(base_keys.shape[0], v, sm_count(base_keys.device)))
    return noise


categorical_cuda.launches = 0
