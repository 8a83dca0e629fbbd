"""Host syncs per generated token over the traced window: the engine's
``steps`` (one sync a decode block) over ``tokens_generated`` (``/stats``
counters, deltas).  1 / K at a full block of K steps; it rises as arrivals
collapse K.  Moves ``output_tokens_per_s``."""
from bench.readers import delta


def read(rec):
    toks = delta(rec, "tokens_generated")
    if not toks:
        return None
    return delta(rec, "steps") / toks
