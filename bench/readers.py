"""What the per-layer readers (``bench/metrics/<metric>.py``) share: the
work of the traced window's decode blocks and prefill waves, counted by
:mod:`bench.roofline.counts`, and counter deltas.  Each function returns
None where the traced window holds nothing to read."""
from __future__ import annotations

from typing import Any, Dict, Optional

from bench.roofline import counts
from bench.roofline.peaks import bound_s
from bench.trace import kernel_seconds

#: kernel names, as the profiler reports them, of each hand-written kernel
PAGED = r"paged_attention|combine_splits"
FLASH_FWD = r"flash_attention(_tc)?_kernel"
FLASH_BWD = r"bwd_delta_kernel|bwd_dkdv_kernel|bwd_dq_kernel|dkdv_kernel|dq_kernel"


def _inside(rec, t_ns: int) -> bool:
    return rec["t0_ns"] <= t_ns < rec["t1_ns"]


def decode_work(rec: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """Summed over every decode step dispatched in the traced window: the
    paged-attention kernel's bound (s) and the steps' operations."""
    cfg = rec["cfg"]
    bound = flops = 0.0
    steps = 0
    for t0, _, k, slots in rec["blocks"]:
        if not _inside(rec, t0):
            continue
        for j in range(k):
            live = [(ctx, clen, c + j) for ctx, clen, c, left in slots
                    if j < left]
            if not live:
                continue
            w = counts.decode_step(cfg, live)
            bound += bound_s(w["attn_flops"], w["attn_bytes"], rec["peaks"])
            flops += w["flops"]
            steps += 1
    if not steps:
        return None
    return {"bound_s": bound, "flops": flops}


def prefill_work(rec: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """Summed over every prefill wave dispatched in the traced window: the
    flash kernel's bound (s) and the waves' operations."""
    cfg = rec["cfg"]
    bound = flops = 0.0
    n = 0
    for t0, _, rows in rec["waves"]:
        if not _inside(rec, t0) or not rows:
            continue
        w = counts.prefill_wave(cfg, rows)
        bound += bound_s(w["attn_flops"], w["attn_bytes"], rec["peaks"])
        flops += w["flops"]
        n += 1
    if not n:
        return None
    return {"bound_s": bound, "flops": flops}


def roofline(bound: Optional[float], kernels, pattern: str
             ) -> Optional[float]:
    """100 x the bound over the kernels' device time."""
    t = kernel_seconds(kernels, pattern)
    if bound is None or not t:
        return None
    return 100.0 * bound / t


def mfu(rec: Dict[str, Any], flops: Optional[float]) -> Optional[float]:
    if flops is None or rec["window_s"] <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * rec["peaks"]["bf16_flops"])


def delta(rec: Dict[str, Any], key: str) -> Optional[int]:
    """A counter's change over the traced window."""
    a, b = rec["counters"]
    if key not in a:
        return None
    return b[key] - a[key]
