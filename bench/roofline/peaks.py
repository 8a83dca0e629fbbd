"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  A share is stated
against these, with the card's power limit beside it."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "fp8_flops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_of(kind: str) -> dict:
    """The peaks of the card named ``kind``; an H100 of another name (a PCIe
    part, a renamed SKU) takes the SXM figures, which bound it from above."""
    return PEAKS.get(kind, PEAKS["NVIDIA H100 80GB HBM3"])


def bound_s(flops: float, nbytes: float, peaks: dict,
            flops_key: str = "bf16_flops") -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / peaks[flops_key], nbytes / peaks["hbm_bytes_per_s"])
