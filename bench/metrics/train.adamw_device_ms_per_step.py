"""Device time of the optimizer's update, in ms a step: the kernels launched
inside the benchmark's span around each ``adamw_update`` call of the traced
steps (matched to their launches by the profiler's correlation ids).
Moves ``train_tokens_per_s``."""
from bench.trace import kernels_launched_in


def read(rec):
    spans = rec["adamw_spans"]
    if not spans or not rec["launches"]:
        return None
    t = kernels_launched_in(rec["kernels"], rec["launches"], spans)
    return 1e3 * t / len(spans) if t > 0 else None
