"""Token sampling: per-slot temperature / top-k / top-p / min-p on the
engine's device (the port of the reference package's ``core/sampling.py``).

Semantics (the reference's, unchanged):

* ``temperature == 0`` is greedy (argmax), independent of every other
  parameter and of the random stream.
* ``top_k`` / ``top_p`` / ``min_p`` each keep a *prefix* of the
  descending-sorted, temperature-scaled distribution; ``top_p``'s cumulative
  mass is renormalised to the surviving top-k prefix (the HF/vLLM
  composition), ``min_p`` compares against the max probability of the full
  distribution.  The keep-set is the shortest of the three prefixes,
  realised as one value threshold (ties at the threshold kept).  ``top_k=0``,
  ``top_p=1`` and ``min_p=0`` are exact no-ops.
* The random stream is **stateless per token**: the draw for the token at
  absolute position ``p`` depends only on the request's base key and ``p``
  — never on batch neighbours, the decode block size K, or whether
  logprobs are collected.

The random streams are JAX's, bit for bit: :func:`threefry2x32` is the
Threefry-2x32 hash of JAX's ``prng`` module on int64 tensors holding uint32
words, and :func:`fold_in`, :func:`split`, :func:`random_bits`,
:func:`uniform`, :func:`gumbel` and :func:`categorical` replay
JAX's ``random`` module under its default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (the counters of element ``i`` are the
words ``(0, i)``).  A seeded request therefore draws the same tokens as in
the reference package, and so does an unseeded one given the same engine
seed and add order.  The bits and the uniforms are exact; ``log`` may
differ from XLA's in the last place, so the Gumbel noise agrees within a
few ulp (tokens agree unless two perturbed logits tie that closely).  The
speculative verifier's auxiliary draws (accept test, correction, draft
sampling) come from salted keys ``fold_in(fold_in(base, salt), position)``
(:func:`fold_salted_keys`), never from the plain stream.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under the
    key words ``(k0, k1)``: int64 tensors holding values in [0, 2**32),
    broadcast together.  Every add and rotate is masked back to 32 bits, so
    no intermediate reaches 2**63."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = x0 ^ (((x1 << r) & _MASK32) | (x1 >> (32 - r)))
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def _words(keys) -> torch.Tensor:
    """Keys as an int64 tensor of uint32 words ``[..., 2]``."""
    if isinstance(keys, torch.Tensor):
        return keys
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))


def keys_array(keys: Sequence) -> np.ndarray:
    """Host keys (uint32 ``[2]`` arrays, one per row) as the ``[k, 2]``
    int64 words the samplers' tensors hold."""
    return np.asarray(np.stack([np.asarray(k) for k in keys]),
                      np.int64).reshape(-1, 2)


def prng_key(seed: int) -> np.ndarray:
    """JAX's ``random.PRNGKey(seed)`` for a seed in [0, 2**32): the words
    ``(0, seed)``."""
    if not 0 <= seed <= _MASK32:
        raise ValueError(f"prng_key takes a seed in [0, 2**32), got {seed}")
    return np.asarray([0, seed], np.uint32)


def fold_in(keys, data) -> torch.Tensor:
    """JAX's ``random.fold_in`` per row: ``keys [..., 2]`` with ``data [...]``
    (or a Python int for every row) folded in as the counter ``(0, data)``."""
    keys = _words(keys)
    if isinstance(data, int):        # no host-to-device copy for a constant
        data = torch.full_like(keys[..., 0], data & _MASK32)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data & _MASK32)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key, num: int = 2) -> np.ndarray:
    """JAX's ``random.split(key, num)`` of one host key: ``[num, 2]`` uint32."""
    k = _words(key)
    ids = torch.arange(num, dtype=torch.int64)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(ids), ids)
    return torch.stack([y0, y1], dim=-1).numpy().astype(np.uint32)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """JAX's ``random.bits(key, shape)`` per row of ``keys [B, 2]``:
    ``[B, *shape]`` int64 holding uint32 values, element ``i`` of the
    flattened shape from the counter ``(0, i)`` (so shape ``()`` is element
    0 of any other shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    ids = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(ids),
                          ids)
    return (y0 ^ y1).reshape(keys.shape[0], *shape)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """JAX's ``random.uniform(key, shape, float32, minval, maxval)`` per row:
    23 random mantissa bits under the exponent of 1.0, minus 1, scaled to
    ``[minval, maxval)`` and clamped below at ``minval`` in float32."""
    bits = random_bits(keys, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    # float32 scalars (a Python scalar enters a float32 op as float32)
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return (f * scale + lo).clamp_min(lo)


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """JAX's ``random.gumbel(key, shape)`` per row (mode ``low``):
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """JAX's ``random.categorical`` under ``vmap``: per row the argmax of
    Gumbel noise plus ``logits [B, V]`` (-inf entries are never drawn)."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def request_base_key(seed: int) -> np.ndarray:
    """Base key of a seeded request (uint32 ``[2]``), a function of the seed
    alone: ``PRNGKey`` of its low word, with the high word folded in when
    it is not 0, so every seed in [0, 2**63) maps to its own key."""
    low, high = seed & _MASK32, seed >> 32
    key = prng_key(low)
    if high:
        key = fold_in(key, high).numpy().astype(np.uint32)
    return key


def fold_step_keys(base_keys: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Per-slot step keys ``fold_in(base, position)``: the stateless
    per-token stream."""
    return fold_in(base_keys, positions)


def fold_salted_keys(base_keys: torch.Tensor, salt: int,
                     positions: torch.Tensor) -> torch.Tensor:
    """Per-slot auxiliary keys ``fold_in(fold_in(base, salt), position)``:
    a stream that shares no draw with the plain one."""
    return fold_in(fold_in(base_keys, salt), positions)


def mask_scaled_logits(
    scaled: torch.Tensor,   # [B, V] f32 — temperature-scaled logits
    top_p: torch.Tensor,    # [B] f32 (1 = off)
    top_k: torch.Tensor,    # [B] int (0 = off)
    min_p: torch.Tensor,    # [B] f32 (0 = off)
) -> torch.Tensor:
    """Apply the per-slot prefix-threshold masks (see module docstring)."""
    vocab = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    top_k = top_k.long()
    n_k = torch.where(top_k > 0, top_k.clamp_max(vocab),
                      torch.full_like(top_k, vocab))
    ranks = torch.arange(vocab, device=scaled.device)[None, :]
    k_mass = torch.gather(cum, 1, (n_k - 1)[:, None])
    denom = torch.where((n_k < vocab)[:, None], k_mass,
                        torch.ones_like(k_mass))
    in_k = ranks < n_k[:, None]
    n_p = torch.where(top_p < 1.0,
                      ((cum / denom < top_p[:, None]) & in_k).sum(-1) + 1,
                      torch.full_like(n_k, vocab))
    n_m = torch.where(min_p > 0.0,
                      (probs >= min_p[:, None] * probs[:, :1]).sum(-1),
                      torch.full_like(n_k, vocab))
    n_keep = torch.minimum(torch.minimum(n_k, n_p), n_m).clamp(1, vocab)
    cutoff = torch.gather(sorted_desc, 1, (n_keep - 1)[:, None])
    return torch.where(scaled < cutoff, float("-inf"), scaled)


def masked_probs(
    logits: torch.Tensor,        # [B, V]
    temperatures: torch.Tensor,  # [B] f32 (0 = greedy)
    top_p: torch.Tensor,         # [B] f32 (1 = off)
    top_k: torch.Tensor,         # [B] int (0 = off)
    min_p: torch.Tensor,         # [B] f32 (0 = off)
) -> torch.Tensor:
    """[B, V] per-slot token distribution under the masked sampler: the
    softmax of the masked scaled logits that the stochastic path draws
    from; greedy slots get the argmax point mass.  The speculative
    verifier's target ``p`` and draft ``q`` of the rejection test."""
    logits = logits.float()
    greedy = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                         logits.shape[-1]).float()
    scaled = logits / temperatures.clamp_min(1e-6)[:, None]
    masked = mask_scaled_logits(scaled, top_p, top_k, min_p)
    return torch.where((temperatures > 0)[:, None],
                       torch.softmax(masked, dim=-1), greedy)


def salted_uniform(base_keys: torch.Tensor, salt: int,
                   positions: torch.Tensor) -> torch.Tensor:
    """[B] float32 uniforms on [0, 1), one per (slot, position), from the
    ``salt`` stream (the accept test's ``u``: JAX's ``random.uniform`` of
    shape ``()``)."""
    return uniform(fold_salted_keys(base_keys, salt, positions), 1)[:, 0]


def salted_categorical(base_keys: torch.Tensor, salt: int,
                       positions: torch.Tensor,
                       log_probs: torch.Tensor) -> torch.Tensor:
    """[B] one draw per slot from ``softmax(log_probs)`` on the ``salt``
    stream (-inf entries are never drawn): ``categorical`` of
    ``fold_salted_keys``, through ``ops.categorical`` (the draw kernel on
    the card)."""
    return ops.categorical(log_probs, base_keys, positions, salt)


def masked_sample_inner(
    logits: torch.Tensor,        # [B, V]
    base_keys: torch.Tensor,     # [B, 2] int64 — per-slot base key words
    positions: torch.Tensor,     # [B] int64 — position of the sampled token
    temperatures: torch.Tensor,  # [B] f32 (0 = greedy)
    top_p: torch.Tensor,         # [B] f32 (1 = off)
    top_k: torch.Tensor,         # [B] int (0 = off)
    min_p: torch.Tensor,         # [B] f32 (0 = off)
    *,
    any_stochastic: bool = True,
    any_mask: bool = True,
) -> torch.Tensor:
    """Sample one token per slot with per-slot masked top-k/top-p/min-p.

    ``any_stochastic`` / ``any_mask`` are the host's knowledge of the batch
    (the reference decides them on device with ``lax.cond``; here a device
    test would cost a host sync per token): with no stochastic slot the call
    is a plain argmax, and with no mask knob set the sort pipeline is
    skipped — both bit-identical to the full path, whose no-op masks leave
    the scaled logits unchanged."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if not any_stochastic:
        return greedy
    scaled = logits / temperatures.clamp_min(1e-6)[:, None]
    if any_mask:
        scaled = mask_scaled_logits(scaled, top_p, top_k, min_p)
    # categorical(fold_step_keys(base_keys, positions), scaled); on the
    # card one kernel draws the noise and takes the argmax
    sampled = ops.categorical(scaled, base_keys, positions)
    return torch.where(temperatures > 0, sampled, greedy)


def keep_set_reference(logits: np.ndarray, temperature: float,
                       top_p: float = 1.0, top_k: int = 0,
                       min_p: float = 0.0) -> np.ndarray:
    """Host reference of one slot's keep-set (bool [V]): an independent
    numpy implementation of the prefix-threshold rule above."""
    row = np.asarray(logits, np.float32)
    scaled = row / np.float32(max(temperature, 1e-6))
    order = np.sort(scaled)[::-1]
    shifted = np.exp(order - order[0])
    probs = shifted / shifted.sum()
    cum = np.cumsum(probs)
    vocab = row.size
    n_k = min(int(top_k), vocab) if top_k > 0 else vocab
    n_keep = n_k
    if top_p < 1.0:
        denom = cum[n_k - 1] if n_k < vocab else np.float32(1.0)
        n_keep = min(n_keep,
                     int(np.sum(cum[:n_k] / denom < np.float32(top_p))) + 1)
    if min_p > 0.0:
        n_keep = min(n_keep,
                     int(np.sum(probs >= np.float32(min_p) * probs[0])))
    n_keep = max(min(n_keep, vocab), 1)
    return scaled >= order[n_keep - 1]


class SamplingParamError(ValueError):
    """Out-of-range sampler parameter; ``param`` names the offender so the
    OpenAI codec can map it into the structured error envelope."""

    def __init__(self, param: str, message: str):
        super().__init__(message)
        self.param = param


def validate_sampling_params(
    top_p: Optional[float], top_k: Optional[int], min_p: Optional[float],
    seed: Optional[int]
) -> None:
    """Range checks, shared by the engine (``add_request``) and the OpenAI
    codec.  ``None`` means "fall back to the engine default"."""
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise SamplingParamError("top_p", f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and top_k < 0:
        raise SamplingParamError("top_k", f"top_k must be >= 0 (0 = off), got {top_k}")
    if min_p is not None and not 0.0 <= min_p < 1.0:
        raise SamplingParamError("min_p", f"min_p must be in [0, 1), got {min_p}")
    if seed is not None and not 0 <= seed < 2**63:
        raise SamplingParamError("seed", f"seed must be an integer in [0, 2**63), got {seed}")
