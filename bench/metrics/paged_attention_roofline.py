"""The paged-attention kernel's share of its roofline in the traced window,
in %: the least time the card needs for the decode steps' attention (a
shared context's pages read once a step) over the device time of the
``paged_attention`` and split-combine kernels.  Moves ``tpot_p95_ms``."""
from bench.readers import PAGED, decode_work, roofline


def read(rec):
    w = decode_work(rec)
    return roofline(None if w is None else w["bound_s"], rec["kernels"],
                    PAGED)
