"""Tree checkpointing: one path-keyed ``.npz``, the reference's
``training/checkpoint.py`` layout.

Keys are the reference's ``_path_str`` of each leaf (``params/block/pos0/
attn/wq``, ``params/prefix_layers/0/...``, ``opt/m/...``, ``opt/step``)
plus ``__step__``, so either package restores the other's float32
checkpoints.  A bfloat16 leaf is written as the reference writes one: numpy
has no bfloat16, and ``np.savez`` of the reference's ``ml_dtypes`` array
stores its raw 16-bit patterns as ``|V2``; the port writes the same bits
and reads them back by reinterpreting them, so it restores bf16
checkpoints bit for bit, the reference's included (the reference's own
restore, ``arr.astype(bfloat16)`` of a ``|V2`` array, raises).  No
``ml_dtypes`` is needed."""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.training.optimizer import (tree_flatten_with_path,
                                            tree_unflatten)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device: raw bf16 bits
    (``|V2``) reinterpreted, anything else cast as ``astype`` would."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"unknown raw dtype {arr.dtype} in checkpoint")
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(path: str, tree: Any, *, step: int = 0) -> None:
    arrays: Dict[str, np.ndarray] = {
        _path_str(p): _to_numpy(leaf)
        for p, leaf in tree_flatten_with_path(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __step__=np.int64(step), **arrays)


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape checked; each leaf in
    ``like``'s dtype and on its device)."""
    with np.load(path) as data:
        leaves = []
        for p, leaf in tree_flatten_with_path(like):
            key = _path_str(p)
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            leaves.append(_from_numpy(arr, leaf))
        return tree_unflatten(like, leaves)


def checkpoint_step(path: str) -> int:
    with np.load(path) as data:
        return int(data["__step__"])
