"""Operation and byte counts against hand counts at a small size."""
import pytest

from bench.roofline import counts
from bench.roofline.peaks import bound_s, peaks_of

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
       "vocab_size": 10}


def test_weights():
    # q 8x8, k and v 8x4 each, o 8x8, MLP 3 x 8x16
    assert counts.layer_weights(CFG) == 64 + 32 + 32 + 64 + 384
    assert counts.head_weights(CFG) == 80
    assert counts.kv_cell_bytes(CFG) == 2 * 2 * 2 * 2


def test_causal_cells():
    assert counts.causal_cells(0, 3) == 1 + 2 + 3
    assert counts.causal_cells(5, 2) == 6 + 7


def test_decode_step_reads_a_shared_context_once():
    # two slots on context 0 (10 cells of it), one on its own
    slots = [(0, 10, 12), (0, 10, 15), (-1, 0, 7)]
    w = counts.decode_step(CFG, slots)
    seen = 12 + 15 + 7
    assert w["attn_flops"] == 4 * 4 * 2 * seen * 2
    cells = 10 + 2 + 5 + 7
    q_out = 2 * 3 * 4 * 2 * 2
    assert w["attn_bytes"] == 2 * (cells * 16 + q_out)
    mm = 2 * (2 * counts.layer_weights(CFG) + 80) * 3
    assert w["flops"] == w["attn_flops"] + mm


def test_prefill_wave():
    # a row resuming at 10 on context 0 (a hit), a fresh row of its own
    rows = [(0, 10, 10, 4, True), (-1, 0, 0, 6, False)]
    w = counts.prefill_wave(CFG, rows)
    seen = (11 + 12 + 13 + 14) + (1 + 2 + 3 + 4 + 5 + 6)
    assert w["attn_flops"] == 4 * 4 * 2 * seen * 2
    cells = 10 + 4 + 6
    assert w["attn_bytes"] == 2 * (cells * 16 + 2 * 10 * 4 * 2 * 2)
    assert w["flops"] == (w["attn_flops"]
                          + 2 * 2 * counts.layer_weights(CFG) * 10
                          + 2 * 80)


def test_train_step():
    w = counts.train_step(CFG, batch=2, seq=3)
    fwd = 4 * 4 * 2 * (2 * 6) * 2
    assert w["bwd_flops"] == 2 * fwd
    assert w["flops"] == 6 * (2 * counts.layer_weights(CFG) + 80) * 6 \
        + 3 * fwd
    per_tok = 4 * 4 * 2 * 2 + 4 * 2 * 2 * 2 + 4 * 4
    assert w["bwd_bytes"] == 2 * 6 * per_tok


def test_bound_takes_the_slower_side():
    p = peaks_of("NVIDIA H100 80GB HBM3")
    assert bound_s(989e12, 0, p) == pytest.approx(1.0)
    assert bound_s(1.0, 3.35e12, p) == pytest.approx(1.0)
    assert peaks_of("some other name") == p
