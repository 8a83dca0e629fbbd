"""The whole training step's share of the card's bf16 peak over the traced
steps, in %: 6 x weights a token plus attention forward and backward over
each causal row, over window x peak.  Moves ``train_tokens_per_s``."""
from bench.readers import mfu
from bench.roofline import counts


def read(rec):
    if not rec["steps"]:
        return None
    mix = rec["traffic"]
    w = counts.train_step(rec["cfg"], mix["batch"], mix["seq"])
    return mfu(rec, rec["steps"] * w["flops"])
