"""Faults planted in the timed path: the tests plant each in a small cell on
the CPU and see ``correct`` come out false; ``bench/control.py --fault``
plants one in a cell at its own size on the chip, for the reading a limit is
set below.  Each function returns ``(owner, attribute, replacement)`` for
``setattr`` (or pytest's ``monkeypatch.setattr``).

* ``token_altered``: every token the decode block produces is replaced by
  the next id.
* ``state_unchanged`` (serving): each decode block leaves the KV arena as it
  found it, so later steps attend over stale cells.
* ``train_state_unchanged``: the optimizer returns the weights and its
  state unchanged.
* ``half_batch``: the loss is the mean over the first half of each batch's
  rows, the rest left out."""
from __future__ import annotations

import torch


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def token_altered():
    from repro_torch.core.engine import InferenceEngine
    block = InferenceEngine._decode_block

    def altered(self, *a, **kw):
        toks, lps = block(self, *a, **kw)
        return torch.where(toks >= 0, (toks + 1) % self.cfg.vocab_size,
                           toks), lps

    return InferenceEngine, "_decode_block", altered


def state_unchanged():
    from repro_torch.core.engine import InferenceEngine
    block = InferenceEngine._decode_block

    def frozen(self, *a, **kw):
        saved = [t.clone() for t in _tensors(self.pool.cache)]
        out = block(self, *a, **kw)
        for dst, src in zip(_tensors(self.pool.cache), saved):
            dst.copy_(src)
        return out

    return InferenceEngine, "_decode_block", frozen


def train_state_unchanged():
    from repro_torch.training import train_step as ts_mod
    return (ts_mod, "adamw_update",
            lambda cfg, params, grads, opt: (params, opt, {}))


def half_batch():
    from repro_torch.training import train_step as ts_mod
    loss_fn = ts_mod.loss_fn

    def half(params, batch, **kw):
        return loss_fn(params, {k: v[: v.shape[0] // 2]
                                for k, v in batch.items()}, **kw)

    return ts_mod, "loss_fn", half


FAULTS = {"token_altered": token_altered, "state_unchanged": state_unchanged,
          "train_state_unchanged": train_state_unchanged,
          "half_batch": half_batch}
