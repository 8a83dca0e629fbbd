"""Most of the paged arena in use at once, in % of its pages: ``/stats``
``kv_pages`` (total - free) / total, polled once a second through the
traced window.  Moves ``output_tokens_per_s``."""


def read(rec):
    polls = [p for p in rec.get("polls", []) if p.get("total")]
    if not polls:
        return None
    return max(100.0 * (p["total"] - p["free"]) / p["total"] for p in polls)
