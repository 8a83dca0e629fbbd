"""The whole serving step's share of the card's bf16 peak in the traced
window, in %: the operations the decode steps and prefill waves needed
(2 x weights a token, the head where logits are taken, attention over the
cells each query sees) over window x peak.  Moves
``output_tokens_per_s``."""
from bench.readers import decode_work, mfu, prefill_work


def read(rec):
    parts = [w["flops"] for w in (decode_work(rec), prefill_work(rec)) if w]
    return mfu(rec, sum(parts)) if parts else None
