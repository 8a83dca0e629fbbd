"""Share of the measured window's requests whose admission found a cached
prefix, in % (each request's ``cached_prefix_len``, as the engine recorded
it).  The cache's own ``hits`` / ``misses`` count one probe per block
length a lookup tries, not lookups.  Moves ``ttft_p95_ms``."""


def read(rec):
    cached = rec.get("cached", [])
    if not cached:
        return None
    return 100.0 * sum(1 for c in cached if c > 0) / len(cached)
