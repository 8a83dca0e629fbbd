"""Share of the traced window in which no kernel or copy ran on the card,
in %, from the profiler's trace.  Moves ``output_tokens_per_s``."""


def read(rec):
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
