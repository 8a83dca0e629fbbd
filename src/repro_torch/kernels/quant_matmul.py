"""Int8 quantisation of the port (the part of the reference's
``kernels/quant_matmul.py`` that the paged KV cache needs).

Only :func:`quantize_kv_int8` is ported: the int8 KV pages of
:class:`repro_torch.core.paged_kv.PagedKVPool` and the paged decode write
use it.  The ``quant_matmul`` kernel itself (reference
``quant_matmul_pallas``) is still to be ported (ROADMAP.md, port queue).
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 quantisation over the LAST axis: ``x``
    ``[..., hd]`` -> ``(int8 [..., hd], float32 scales [...])`` with
    ``dequant = q.float() * scales[..., None]``.  The scale is
    ``max(absmax, 1e-8) / 127``; values round half to even (as JAX's ``round``
    does) and clip to +-127, so the result is bit-identical to the
    reference's."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scales = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scales[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scales
