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

What differs from the reference: the stream is a counter-based hash
(:func:`uniform_noise`), turned into a categorical draw by the Gumbel-max
rule, not JAX's threefry generator, so a seeded request draws other tokens
than it does in the reference package (bit-replay of those streams is a
ROADMAP item).  Greedy tokens are unaffected.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def request_base_key(seed: int) -> int:
    """Base key of a seeded request: the seed itself (a 63-bit integer), so
    seeded replay holds across runs, processes and batch compositions."""
    return int(seed)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) on int64 tensors holding values in
    [0, 2**32): every product stays below 2**63, so nothing overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def uniform_noise(base_keys: torch.Tensor, positions: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """[B, V] float32 uniforms in (0, 1), a pure function of (key, position,
    token id): the stateless per-token stream."""
    lo, hi = base_keys & _MASK32, (base_keys >> 32) & _MASK32
    h = _mix32(_mix32(lo ^ _mix32(hi)) ^ (positions & _MASK32))     # [B]
    ids = torch.arange(vocab, device=base_keys.device, dtype=torch.int64)
    bits = _mix32(h[:, None] ^ _mix32((ids + 0x9E3779B9) & _MASK32)[None, :])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


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


def masked_sample_inner(
    logits: torch.Tensor,        # [B, V]
    base_keys: torch.Tensor,     # [B] int64 — per-slot base keys
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
    u = uniform_noise(base_keys, positions, logits.shape[-1])
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
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
