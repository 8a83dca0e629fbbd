"""AdamW with a cosine schedule and global-norm clipping: the reference's
``training/optimizer.py`` over the port's dict and list trees.

Moments are float32 whatever the param dtype (bf16 training); the update is
computed in float32 and cast back.  The schedule, the clip scale and the
bias corrections are float32 tensors computed as the reference computes
them (not Python doubles), and leaves are taken in the reference's
flattening order (dict keys sorted, lists in order), so the global norm
sums in the reference's order.  Decoupled weight decay applies to every
leaf with ``p.dim() >= 2``, as the reference's ``p.ndim >= 2``: that
includes the stacked ``block/pos{i}`` norm weights and qkv biases
(``[repeats, D]``), not the un-stacked ``prefix_layers`` vectors."""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.model import tree_map


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def tree_flatten_with_path(tree: Any, prefix: Tuple = ()) -> List[Tuple]:
    """``[(path, leaf)]`` in JAX's flattening order: dict keys sorted,
    lists and tuples in order, None an empty subtree.  ``path`` holds the
    dict keys and list indices from the root."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of ``tree`` in JAX's flattening order."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure (its dicts' key order too) holding
    ``leaves``, taken in the order of :func:`tree_leaves`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(like)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``lr * min_lr_ratio``
    at ``total_steps``; float32."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> Dict[str, Any]:
    """Zero float32 moments shaped like ``params``, on each leaf's device,
    and an int32 step counter."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt`` of the float32 sum of squares, leaf sums added in the
    reference's order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 opt_state: Dict[str, Any]
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, written into the tensors of ``params`` and
    ``opt_state`` leaf by leaf (one leaf's float32 temporaries live at a
    time): returns (params, opt_state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.beta1 ** step.to(torch.float32)
    b2c = 1 - cfg.beta2 ** step.to(torch.float32)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.float() * scale
        m.copy_(cfg.beta1 * m + (1 - cfg.beta1) * g)
        v.copy_(cfg.beta2 * v + (1 - cfg.beta2) * g * g)
        mhat, vhat = m / b1c, v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:                      # decoupled decay on matrices
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"].copy_(step)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
