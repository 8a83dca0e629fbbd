"""Tokens a decode step generated, on average over the traced window: the
engine's ``tokens_generated`` over its ``device_steps`` (``/stats``
counters, deltas).  Moves ``output_tokens_per_s``."""
from bench.readers import delta


def read(rec):
    steps = delta(rec, "device_steps")
    if not steps:
        return None
    return delta(rec, "tokens_generated") / steps
