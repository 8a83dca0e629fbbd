"""The one generator of every traffic mix: it reads the parameters of a mix
(``bench/traffic/<mix>.json``) and makes its requests or training batches
from ``--seed``.  Stdlib and NumPy only: the load generator's process
imports it.

Serving (``"kind": "serve"``).  Request ``i`` is drawn from its stratum of
``stratum`` consecutive requests: within a stratum each drawn quantity
(suffix length, ``max_tokens``, the shared context picked) takes every
quantile ``(j + 0.5) / stratum`` of its distribution once, in an order
shuffled by the seed.  So every seed sends the same sizes in another order,
and any window of a few strata carries the whole mix.  A prompt is a
context of ``context.tokens`` ids (one of ``context.count`` shared ones,
picked by Zipf's law, or one of its own) followed by a suffix of its own;
ids are uniform over the whole vocabulary.

Training (``"kind": "train"``).  Documents of log-normal lengths, clipped
to ``[doc_len.min, doc_len.max]``, ids uniform over the vocabulary, are
packed back to back into rows of ``seq + 1`` tokens with ``eos`` between
them; consecutive rows continue the stream, so no two rows are alike."""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

#: tags of the seeded streams (their values fix what a seed draws)
_STRATA, _TOKENS, _CONTEXT, _UNIQUE, _DOCS = 0, 3, 4, 5, 6


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def _quantile(dist: Dict[str, Any], u: float) -> int:
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "log-uniform":
        v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return int(min(hi, max(lo, round(v))))


def _zipf_pick(n: int, s: float, u: float) -> int:
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(w / w.sum())
    return int(min(n - 1, np.searchsorted(cdf, u, side="right")))


def _stratum_ranks(traffic: Dict[str, Any], seed: int, block: int
                   ) -> np.ndarray:
    """[3, stratum]: each drawn quantity's quantile index per request of
    stratum ``block``."""
    n = traffic["stratum"]
    rng = np.random.default_rng([_seed(seed), block, _STRATA])
    return np.stack([rng.permutation(n) for _ in range(3)])


def request_plan(traffic: Dict[str, Any], seed: int, i: int
                 ) -> Dict[str, int]:
    """Sizes of request ``i``: ``context`` (the shared context's index, or
    -1 for one of its own), ``suffix`` and ``max_tokens``."""
    n = traffic["stratum"]
    ranks = _stratum_ranks(traffic, seed, i // n)[:, i % n]
    us = (ranks + 0.5) / n
    ctx = traffic["context"]
    pick = (_zipf_pick(ctx["count"], ctx["zipf_s"], float(us[2]))
            if ctx["shared"] else -1)
    return {"context": pick,
            "suffix": _quantile(traffic["suffix"], float(us[0])),
            "max_tokens": _quantile(traffic["max_tokens"], float(us[1]))}


def context_tokens(traffic: Dict[str, Any], seed: int, c: int,
                   vocab: int) -> List[int]:
    rng = np.random.default_rng([_seed(seed), c, _CONTEXT])
    return rng.integers(0, vocab, traffic["context"]["tokens"]).tolist()


def request(traffic: Dict[str, Any], seed: int, i: int, vocab: int
            ) -> Dict[str, Any]:
    """Request ``i``: its plan, its ``prompt`` ids and its ``max_tokens``."""
    plan = request_plan(traffic, seed, i)
    if plan["context"] >= 0:
        head = context_tokens(traffic, seed, plan["context"], vocab)
    else:
        rng = np.random.default_rng([_seed(seed), i, _UNIQUE])
        head = rng.integers(0, vocab, traffic["context"]["tokens"]).tolist()
    rng = np.random.default_rng([_seed(seed), i, _TOKENS])
    tail = rng.integers(0, vocab, plan["suffix"]).tolist()
    return dict(plan, index=i, prompt=head + tail)


def train_rows(traffic: Dict[str, Any], seed: int, steps: int, vocab: int,
               eos: int) -> np.ndarray:
    """[steps, batch, seq + 1] int64: the packed stream of ``steps``
    batches."""
    b, s = traffic["batch"], traffic["seq"]
    total = steps * b * (s + 1)
    rng = np.random.default_rng([_seed(seed), _DOCS])
    d = traffic["doc_len"]
    lens = np.exp(rng.normal(math.log(d["median"]), d["sigma"],
                             size=total // d["min"] + 1))
    lens = np.clip(np.rint(lens), d["min"], d["max"]).astype(np.int64)
    stream = rng.integers(0, vocab, total, dtype=np.int64)
    ends = np.cumsum(lens + 1) - 1
    stream[ends[ends < total]] = eos
    return stream.reshape(steps, b, s + 1)
