"""The comparisons that decide ``correct``, each number with its limit.

Serving: a sample of the requests the window finished, drawn from the seed
and holding the one that served the most tokens, is run through the plain
reference over its prompt and served tokens.  Compared: the widest gap by
which a served token's reference logit lies below the reference's best at
its position (greedy decoding serves the best token, so a sound program
reads only its rounding); the tokens and logprobs the client streamed
against those the engine recorded (exact); the requests of the window
that failed (none may); and how far the sample falls short of the served
tokens it has to hold (it may not).

Training: the reference follows the program's first three steps from the
same weights on the same batches.  Compared: each step's loss (relative
gap); per leaf, the norm of the first step's clipped gradient as the
optimizer got it (its first moment after one step over ``1 - beta1``) and
the norm of the change of the stored weights after the three steps, each
as the gap between the program's norm and the reference's over the larger
of the reference's norm of that leaf and of the median leaf, worst leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a key bias under softmax) move by round-off alone and are left
out of the change."""
from __future__ import annotations

import statistics
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from bench import traffic as gen
from bench.reference import dense_lm


def serve_sample(reqs: List[Dict[str, Any]], t0: float, seed: int,
                 tokens: int, most: int) -> List[Dict[str, Any]]:
    """Finished requests sent in the window: the one that served the most
    tokens, then others in an order drawn from the seed, until ``tokens``
    served tokens or ``most`` requests."""
    ok = [r for r in reqs if r["t_send"] >= t0 and r["error"] is None
          and r["finish"] is not None and r["times"]]
    if not ok:
        return []
    ok.sort(key=lambda r: r["index"])
    longest = max(ok, key=lambda r: (len(r["times"]), r["prompt_len"]))
    rest = [r for r in ok if r is not longest]
    order = np.random.default_rng([int(seed) % (1 << 64), 11]).permutation(
        len(rest))
    out, n = [longest], len(longest["times"])
    for j in order:
        if n >= tokens or len(out) >= most:
            break
        out.append(rest[j])
        n += len(rest[j]["times"])
    return out


def serve_gaps(logits: torch.Tensor, tokens: List[int]) -> torch.Tensor:
    """Per row, the best logit minus the logit of ``tokens``' entry."""
    idx = torch.as_tensor(tokens, device=logits.device)[:, None]
    return logits.max(dim=-1).values - logits.gather(-1, idx)[:, 0]


def served_inputs(mix, seed, vocab, sample, served):
    seqs, rows, toks = [], [], []
    for r in sample:
        prompt = gen.request(mix, seed, r["index"], vocab)["prompt"]
        out = list(served[r["index"]].tokens)
        seqs.append(prompt + out[:-1])
        rows.append(range(len(prompt) - 1, len(prompt) - 1 + len(out)))
        toks.append(out)
    return seqs, rows, toks


def check_serve(params, cfg, mix, seed, sample, served, failed
                ) -> Dict[str, Dict[str, Any]]:
    lim = cfg["checks"]
    mismatch = 0
    for r in sample:
        c = served[r["index"]]
        lps = [lp for lp, _ in c.logprobs]
        if len(c.tokens) != len(r["times"]) or lps != r["logprobs"]:
            mismatch += 1
    gap = float("inf")
    n_tok = 0
    if sample:
        seqs, rows, toks = served_inputs(mix, seed, cfg["vocab_size"],
                                         sample, served)
        logits = dense_lm.served_logits(params, cfg, seqs, rows)
        gap = max(float(serve_gaps(lg, t).max())
                  for lg, t in zip(logits, toks))
        n_tok = sum(len(t) for t in toks)
    return {
        "logit_gap": {"value": gap, "limit": lim["logit_gap"]},
        "stream_mismatch": {"value": mismatch, "limit": 0},
        "failed": {"value": failed, "limit": 0},
        "tokens_short": {"value": max(0, lim["sample_min"] - n_tok),
                         "limit": 0},
    }


def _rel_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any]
                  ) -> Dict[str, float]:
    """The three compared numbers of a training cell (see the module)."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    keys = sorted(ref["first_grad"])
    grad = _rel_gaps(prog["first_grad"], ref["first_grad"], keys)
    med = statistics.median(ref["first_grad"][k] for k in keys)
    moved = [k for k in keys if ref["first_grad"][k] >= 1e-3 * med]
    change = _rel_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def check_train(prog, ref, cfg) -> Dict[str, Dict[str, Any]]:
    """The numbers the configuration gives a limit; ``loss_gap`` has none
    (no control or fault reads three times its sound readings, see
    ``PERF.md``) and is printed beside them."""
    nums = train_numbers(prog, ref)
    lim = cfg["checks"]
    print(f"train: loss_gap {nums['loss_gap']!r} (not compared)",
          file=sys.stderr, flush=True)
    return {k: {"value": v, "limit": lim[k]} for k, v in nums.items()
            if k in lim}


def reference_train(params0, cfg, batches, quant=None):
    return dense_lm.train_steps(params0, cfg, batches, cfg["train"]["adamw"],
                                quant)
