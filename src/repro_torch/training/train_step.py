"""The training step: masked LM cross-entropy (+ the MoE load-balance loss)
and an AdamW update, the reference's ``training/train_step.py`` in PyTorch.

The loss runs ``Model.apply(mode="train")`` through ``ops``: on the card
every attention call is the flash kernel with the backward kernel behind it
(``FlashAttentionFn``) and every norm the rmsnorm kernel (``RmsnormFn``).
Gradients come from ``torch.autograd.grad`` over the params' leaves in the
reference's flattening order; ``microbatches > 1`` accumulates them in
float32 over a Python loop, as the reference's scan does.  The step
updates the state's tensors in place and returns float metrics.

Traced as ``train.step`` with the children ``train.batch_to``,
``train.forward`` (``loss_fn``), ``train.backward`` (``autograd.grad``),
``train.optimizer`` (``adamw_update``) and ``train.metrics_sync`` (the
metrics' ``float()``: the host waiting on the card)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, tree_leaves,
                                            tree_unflatten)
from repro_torch.tracing import TRACER

_INDEX_KEYS = ("tokens", "labels")


def init_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None, *,
                     params: Any = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """``{"params", "opt"}``: ``params`` as given (the tests bridge the
    reference's with ``params_from_jax``), else ``Model(cfg).init`` from
    ``generator`` on ``device`` (``cuda`` unless the caller asks for
    another); zero moments beside them."""
    if params is None:
        params = Model(cfg).init(generator, device)
    return {"params": params, "opt": init_opt_state(params)}


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``; token ids and
    labels as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        out[k] = t.to(device=device,
                      dtype=torch.long if k in _INDEX_KEYS else None)
    return out


def loss_fn(params: Any, batch: Dict[str, torch.Tensor], *, cfg: ModelConfig,
            attn_schedule: str = "full", remat: bool = True,
            unroll_scan: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"lm_loss", "aux_loss"}): the mean next-token NLL over the
    ``mask``ed positions, from float32 logits, plus the MoE aux loss."""
    kw = {}
    if cfg.vision is not None:
        kw["image_embeds"] = batch["image_embeds"]
    if cfg.audio is not None:
        kw["audio_frames"] = batch["audio_frames"]
    out = Model(cfg).apply(params, batch["tokens"], mode="train", remat=remat,
                           attn_schedule=attn_schedule,
                           unroll_scan=unroll_scan, **kw)
    logp = torch.log_softmax(out.logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch["mask"].float()
    lm_loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = lm_loss + out.aux_loss
    return loss, {"lm_loss": lm_loss, "aux_loss": out.aux_loss}


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor], *,
                   cfg: ModelConfig, **kw):
    """(loss, parts, grads): ``grads`` a list in :func:`tree_leaves` order
    of ``params``, None for a leaf the loss does not reach.  The params'
    leaves require grad only for the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with TRACER.span("train.forward"):
            loss, parts = loss_fn(params, batch, cfg=cfg, **kw)
        with TRACER.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            list(grads))


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, attn_schedule: str = "full", remat: bool = True,
                    unroll_scan: bool = False, microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: the state's params
    and moments updated in place, metrics ``loss``, ``lm_loss``,
    ``aux_loss``, ``lr`` and ``grad_norm`` as floats
    (``train_step.tensors`` gives them as tensors, with no host sync: the
    dry-run's step over meta DTensors).  ``microbatches > 1``
    splits the batch on its first axis and accumulates float32 gradients
    over a Python loop."""
    opt_cfg = opt_cfg or AdamWConfig()
    kw = dict(cfg=cfg, attn_schedule=attn_schedule, remat=remat,
              unroll_scan=unroll_scan)

    def grads_of(params, mb):
        loss, parts, grads = loss_and_grads(params, mb, **kw)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(tree_leaves(params), grads)]
        return loss, parts, grads

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Dict[str, float]]:
        with TRACER.span("train.step"):
            state, metrics = train_step_tensors(state, batch)
            with TRACER.span("train.metrics_sync"):
                return state, {k: float(v) for k, v in metrics.items()}

    def train_step_tensors(state: Dict[str, Any], batch: Dict[str, Any]
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        params = state["params"]
        device = tree_leaves(params)[0].device
        with TRACER.span("train.batch_to"):
            batch = batch_to(batch, device)
        if microbatches == 1:
            loss, parts, grads = grads_of(params, batch)
        else:
            def split(x):
                b = x.shape[0]
                assert b % microbatches == 0
                return x.reshape((microbatches, b // microbatches)
                                 + tuple(x.shape[1:]))

            mbs = {k: split(v) for k, v in batch.items()}
            g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                     for p in tree_leaves(params)]
            l_acc = torch.zeros((), dtype=torch.float32, device=device)
            a_acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(microbatches):
                loss_i, parts_i, g = grads_of(
                    params, {k: v[i] for k, v in mbs.items()})
                g_acc = [a + b_.float() for a, b_ in zip(g_acc, g)]
                l_acc = l_acc + loss_i
                a_acc = a_acc + parts_i["aux_loss"]
            grads = [g / microbatches for g in g_acc]
            loss = l_acc / microbatches
            parts = {"lm_loss": loss - a_acc / microbatches,
                     "aux_loss": a_acc / microbatches}
        with TRACER.span("train.optimizer"):
            _, _, opt_metrics = adamw_update(
                opt_cfg, params, tree_unflatten(params, grads), state["opt"])
        return state, {"loss": loss, **parts, **opt_metrics}

    train_step.tensors = train_step_tensors
    return train_step
