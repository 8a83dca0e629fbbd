"""Weight bridge: the reference model's params (as numpy) -> the port's.

The reference's ``Model.init`` returns a pytree of dicts and lists whose
leaves, once converted with ``numpy.asarray``, this module turns into torch
tensors of the same structure: ``embed``, ``final_ln``, optional
``lm_head``, ``prefix_layers`` and ``block/pos{i}`` with its leading repeat
axis.  The port keeps the reference's ``[in, out]`` weight layout
(``x @ w``), so no leaf is transposed.  Each float leaf gets the dtype the
port's own ``Model.init`` gives it: ``cfg.dtype``, or float32 for the
leaves the reference keeps in float32 (``layers.FLOAT32_PARAMS``: the MoE
router).  bfloat16 leaves (a numpy extension dtype) go through float32,
which is exact.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import FLOAT32_PARAMS, dtype_of


def params_from_jax(np_tree: Any, cfg: ModelConfig,
                    device: DeviceLike = None) -> Any:
    """Copy a numpy params tree into torch tensors on ``device`` (``cuda``
    unless the caller asks for another), each float leaf in the dtype the
    port's ``Model.init`` gives it."""
    device = resolve_device(device)
    dt = dtype_of(cfg.dtype)

    def conv(name, a):
        a = np.asarray(a)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(a, np.float32)).to(
                device=device,
                dtype=torch.float32 if name in FLOAT32_PARAMS else dt)
        return torch.from_numpy(np.array(a)).to(device)

    def walk(name, t):
        if isinstance(t, dict):
            return {k: walk(k, v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(name, v) for v in t]
        return conv(name, t)

    return walk(None, np_tree)
