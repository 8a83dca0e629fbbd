"""95th percentile over the requests completed in the measured window
before the traced stretch (the profiler's start and stop stall the host)
of (last token - first token) / (tokens - 1), in ms, from the client's
stamps.
In these cells the card idles most of the window, so the tail follows the
host: it stands here, not among the end-to-end metrics.  Moves
``output_tokens_per_s``."""


def read(rec):
    return rec.get("e2e", {}).get("tpot_p95_ms")
