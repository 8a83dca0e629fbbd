"""The device every entry point of the port runs on."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``cuda`` unless the caller asks for another device.  With no card and
    no explicit request this raises: the port never falls back to the CPU on
    its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)
