"""A run driven whole on the CPU at a small size (the harness's look for a
card skipped), sound and with the timed path broken underneath: the sound
run comes out correct, and each fault the cell can have comes out not
correct.  Serving: a token altered where the engine produces it; a decode
step that leaves its state (the KV arena) unchanged.  Training: a step that
leaves its state unchanged; half of each batch left out, the mean taken
over the rest.  And the control at the small size: the float8 reference in
the program's place reads above the limits the sound program reads
under."""
import time

import pytest
import torch

from bench import correct, faults, serve
from bench.reference import dense_lm
from bench.run import run_cell
from bench.tests.bench_small import small_cell

SERVE = "codeqwen1.5-7b.repo-context"
TRAIN = "qwen2-0.5b.train-packed-1k"
CPU = torch.device("cpu")


def run_small(name, seconds=3.0, keep=None):
    cell, pc = small_cell(name)
    result, checks = run_cell(cell, 2**31 + 77, seconds, False, CPU,
                              time.monotonic(), port_cfg=pc, keep=keep)
    return result, checks


def test_sound_serving_run_is_correct():
    keep = {}
    result, checks = run_small(SERVE, keep=keep)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"output_tokens_per_s", "setup_s"}
    # the control at this size: the float8 reference's first tokens
    cell, _ = small_cell(SERVE)
    seqs, rows, toks = correct.served_inputs(
        cell["traffic"], 2**31 + 77, cell["config"]["vocab_size"],
        keep["sample"], keep["served"])
    ref = dense_lm.served_logits(keep["params"], cell["config"], seqs, rows)
    low = dense_lm.served_logits(keep["params"], cell["config"], seqs, rows,
                                 quant="fp8")
    control = max(float(correct.serve_gaps(r, lo.argmax(-1).tolist()).max())
                  for r, lo in zip(ref, low))
    assert checks["logit_gap"]["value"] < checks["logit_gap"]["limit"]
    assert control > checks["logit_gap"]["limit"]


def test_serving_token_altered_is_caught(monkeypatch):
    monkeypatch.setattr(*faults.token_altered())
    result, checks = run_small(SERVE)
    assert not result["correct"]
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def test_serving_state_left_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(*faults.state_unchanged())
    result, checks = run_small(SERVE)
    assert not result["correct"]
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def test_sound_training_run_is_correct():
    keep = {}
    result, checks = run_small(TRAIN, keep=keep)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    cell, _ = small_cell(TRAIN)
    low = correct.reference_train(keep["start"], cell["config"],
                                  keep["batches"], quant="fp8")
    nums = correct.train_numbers(low, keep["ref"])
    assert any(nums[k] > checks[k]["limit"] for k in checks)


def test_training_state_left_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(*faults.train_state_unchanged())
    result, checks = run_small(TRAIN)
    assert not result["correct"]
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch_is_caught(monkeypatch):
    monkeypatch.setattr(*faults.half_batch())
    result, checks = run_small(TRAIN)
    assert not result["correct"]
    assert max(checks[k]["value"] / checks[k]["limit"]
               for k in ("grad_gap", "change_gap")) > 1


def test_serving_end_to_end_arithmetic():
    reqs = [
        {"t_send": 0.5, "times": [0.6, 0.7], "error": None},       # before
        {"t_send": 1.0, "times": [1.2, 1.3, 1.5], "error": None},
        {"t_send": 1.5, "times": [], "error": "http 500"},          # failed
        {"t_send": 2.0, "times": [2.1, 2.4, 3.2], "error": None},   # ends late
    ]
    e = serve.end_to_end(reqs, 1.0, 3.0)
    assert e["output_tokens_per_s"] == 5 / 2.0      # 0.6, 0.7, 3.2 outside
    assert e["attempted"] == 3 and e["failed"] == 1
    assert e["ttft_p95_ms"] == float("inf")
    assert e["completed"] == 1
    assert e["tpot_p95_ms"] == pytest.approx(150.0)
