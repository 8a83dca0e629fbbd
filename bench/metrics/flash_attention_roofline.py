"""The flash-attention forward's share of its roofline in the prefill waves
of the traced window, in %: the least time the card needs for the uncached
queries over their full causal contexts over the device time of the flash
kernels.  Moves ``ttft_p95_ms``."""
from bench.readers import FLASH_FWD, prefill_work, roofline


def read(rec):
    w = prefill_work(rec)
    return roofline(None if w is None else w["bound_s"], rec["kernels"],
                    FLASH_FWD)
