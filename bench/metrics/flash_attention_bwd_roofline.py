"""The flash-attention backward's share of its roofline over the traced
steps, in %: the least time the card needs for the backward the steps
need (dP, dV, dQ, dK over each causal row; Q, K, V, O, dO and the
log-sum-exp read once, dQ, dK, dV written once) over the device time of
the backward's kernels.  Moves ``train_tokens_per_s``."""
from bench.readers import FLASH_BWD, roofline
from bench.roofline import counts
from bench.roofline.peaks import bound_s


def read(rec):
    if not rec["steps"]:
        return None
    mix = rec["traffic"]
    w = counts.train_step(rec["cfg"], mix["batch"], mix["seq"])
    bound = rec["steps"] * bound_s(w["bwd_flops"], w["bwd_bytes"],
                                   rec["peaks"])
    return roofline(bound, rec["kernels"], FLASH_BWD)
