"""Operations and bytes that the traffic needs, whatever implements it.

Counted from the configuration's sizes and the work the traffic asked for
(prompt lengths, the part of each prompt that is a shared context, token
positions), never from what a kernel happens to read.  Every input byte
counts once per kernel call and every output byte once: cells of a context
that several rows of one call share are read once.  An attention query at
a position that sees ``c`` cells (itself included) costs ``4 * H * D * c``
operations (``Q K^T`` and ``P V``); the backward needs twice the forward's
(``dP``, ``dV``, ``dQ``, ``dK``; recomputing ``Q K^T`` is the kernel's
choice, not the traffic's need).  A matrix product with ``N`` weights costs
``2 N`` operations a token forward and ``4 N`` backward; an embedding
lookup costs none."""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

BF16 = 2
F32 = 4


def layer_weights(cfg: Dict[str, Any]) -> int:
    """Weights of one layer's matrix products (the biases and norms add no
    products)."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    qo = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    return d * qo + 2 * d * kv + qo * d + 3 * d * ff


def head_weights(cfg: Dict[str, Any]) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def kv_cell_bytes(cfg: Dict[str, Any], kv_bytes: int = BF16) -> int:
    """K and V of one position in one layer."""
    return 2 * cfg["num_key_value_heads"] * cfg["head_dim"] * kv_bytes


def attn_flops(cfg: Dict[str, Any], cells: float) -> float:
    """Forward attention operations of queries that see ``cells`` cells in
    all (summed over the queries), over every layer."""
    return (4.0 * cfg["num_attention_heads"] * cfg["head_dim"] * cells
            * cfg["num_hidden_layers"])


def causal_cells(start: int, count: int) -> int:
    """Cells seen by ``count`` queries at positions ``start .. start +
    count - 1`` of a causal sequence."""
    return count * start + count * (count + 1) // 2


def _q_out_bytes(cfg: Dict[str, Any], rows: int) -> int:
    return 2 * rows * cfg["num_attention_heads"] * cfg["head_dim"] * BF16


def decode_step(cfg: Dict[str, Any],
                slots: Iterable[Tuple[int, int, int]]) -> Dict[str, float]:
    """One decode step of the live slots, each ``(context, context_len,
    cells)``: ``context`` the shared context's id (-1: none), ``cells`` the
    cells its query sees.  Returns the paged-attention kernel's
    ``attn_flops`` and ``attn_bytes`` (a shared context's cells read once
    per call) and the whole step's ``flops``."""
    slots = list(slots)
    n_layers = cfg["num_hidden_layers"]
    seen = sum(c for _, _, c in slots)
    shared: Dict[int, int] = {}
    own = 0
    for ctx, ctx_len, c in slots:
        if ctx >= 0:
            part = min(ctx_len, c)
            shared[ctx] = max(shared.get(ctx, 0), part)
            own += c - part
        else:
            own += c
    cells = own + sum(shared.values())
    a_flops = attn_flops(cfg, seen)
    a_bytes = n_layers * (cells * kv_cell_bytes(cfg)
                          + _q_out_bytes(cfg, len(slots)))
    mm = 2.0 * (n_layers * layer_weights(cfg) + head_weights(cfg))
    return {"attn_flops": a_flops, "attn_bytes": a_bytes,
            "flops": a_flops + mm * len(slots)}


def prefill_wave(cfg: Dict[str, Any],
                 rows: Iterable[Tuple[int, int, int, int, bool]]
                 ) -> Dict[str, float]:
    """One prefill wave, each row ``(context, context_len, start, take,
    last)``: ``take`` uncached queries from position ``start`` over their
    full causal contexts, ``last`` when the chunk ends the prompt (the head
    then runs on its last row).  Returns the flash kernel's ``attn_flops``
    and ``attn_bytes`` and the wave's ``flops``."""
    rows = list(rows)
    n_layers = cfg["num_hidden_layers"]
    seen = sum(causal_cells(s, t) for _, _, s, t, _ in rows)
    shared: Dict[int, int] = {}
    own = 0
    for ctx, ctx_len, s, t, _ in rows:
        end = s + t
        if ctx >= 0:
            part = min(ctx_len, end)
            shared[ctx] = max(shared.get(ctx, 0), part)
            own += end - part
        else:
            own += end
    cells = own + sum(shared.values())
    taken = sum(t for _, _, _, t, _ in rows)
    a_flops = attn_flops(cfg, seen)
    a_bytes = n_layers * (cells * kv_cell_bytes(cfg)
                          + _q_out_bytes(cfg, taken))
    heads = sum(1 for *_, last in rows if last)
    flops = (a_flops + 2.0 * n_layers * layer_weights(cfg) * taken
             + 2.0 * head_weights(cfg) * heads)
    return {"attn_flops": a_flops, "attn_bytes": a_bytes, "flops": flops}


def train_step(cfg: Dict[str, Any], batch: int, seq: int
               ) -> Dict[str, float]:
    """One training step over ``batch`` rows of ``seq`` tokens, causal over
    each row: the whole step's ``flops`` and the flash backward's
    ``bwd_flops`` and ``bwd_bytes`` (Q, K, V, O, dO and the float32
    log-sum-exp read, dQ, dK and dV written, in bf16)."""
    n_layers = cfg["num_hidden_layers"]
    tokens = batch * seq
    fwd_attn = attn_flops(cfg, batch * causal_cells(0, seq))
    mm = 6.0 * (n_layers * layer_weights(cfg) + head_weights(cfg)) * tokens
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    per_token = (4 * h * hd * BF16            # q, o, dO read; dQ written
                 + 4 * hkv * hd * BF16        # k, v read; dK, dV written
                 + h * F32)                   # the log-sum-exp
    return {"flops": mm + 3.0 * fwd_attn, "bwd_flops": 2.0 * fwd_attn,
            "bwd_bytes": float(n_layers * tokens * per_token)}
