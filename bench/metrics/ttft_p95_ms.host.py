"""95th percentile of time to first token over every request sent in the
measured window before the traced stretch (the profiler's start and stop
stall the host), in ms, from the client's stamps (a request that failed or
never streamed a token counts as missing).  In these cells the card idles
most of the window, so the tail follows the host: it stands here, not
among the end-to-end metrics.  Moves ``output_tokens_per_s``."""


def read(rec):
    return rec.get("e2e", {}).get("ttft_p95_ms")
