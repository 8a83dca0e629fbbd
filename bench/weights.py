"""Weights from ``--seed``, made on the device in the port's parameter layout
of a dense decoder (``Model.apply``'s tree: ``embed``, ``final_ln``,
``lm_head`` unless tied, no prefix layers, and one repeat group
``block/pos0`` whose leaves stack the layers on a leading axis).

Each leaf is one draw of a ``torch.Generator`` on the device, in the dtype
the configuration serves: a matrix ``N(0, 1/fan_in)`` as the port
initialises it, a norm weight ``1 + N(0, 0.05^2)`` and a bias
``N(0, 0.05^2)`` (the port starts those at 1 and 0, which would leave the
norm weights and the biases out of what the check compares).  An embedding
is ``N(0, init.embed_std^2)`` where the configuration gives that scale: at
``1/sqrt(vocab)`` a token's own signal is drowned by the first layer's
output, and a deep stack then puts one token first at nearly every
position on some seeds (rank collapse), where the check has nothing left
to compare.  Without it (a tied embedding is also the head) the embedding
keeps the fan-in rule.  The same tensors go to the program and to the
plain reference."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: Dict[str, Any]) -> torch.dtype:
    return _DTYPES[cfg["torch_dtype"]]


#: the configuration file's keys and the program's ``ModelConfig`` fields
#: they set
PROGRAM_FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
                  "num_hidden_layers": "num_layers",
                  "num_attention_heads": "num_heads",
                  "num_key_value_heads": "num_kv_heads",
                  "head_dim": "head_dim", "vocab_size": "vocab_size",
                  "rope_theta": "rope_theta", "rms_norm_eps": "rms_eps",
                  "qkv_bias": "qkv_bias",
                  "tie_word_embeddings": "tie_embeddings",
                  "torch_dtype": "dtype"}


def program_config(cfg: Dict[str, Any]):
    """The program's configuration of the model at the file's sizes: its own
    configuration named ``port_config`` (the family and what the file does
    not state) with every size the file states put in, so that the
    program, the weights, the reference and the counts read one set of
    widths, the file's."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config(cfg["port_config"]),
        **{field: cfg[key] for key, field in PROGRAM_FIELDS.items()})


def leaf_shapes(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of leaf shapes."""
    d, v, n = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, ff = cfg["head_dim"], cfg["intermediate_size"]
    attn = {"ln": (n, d), "wq": (n, d, h * hd), "wk": (n, d, hkv * hd),
            "wv": (n, d, hkv * hd), "wo": (n, h * hd, d)}
    if cfg["qkv_bias"]:
        attn.update(bq=(n, h * hd), bk=(n, hkv * hd), bv=(n, hkv * hd))
    tree = {"embed": (v, d), "final_ln": (d,), "prefix_layers": [],
            "block": {"pos0": {"attn": attn, "ffn_ln": (n, d),
                               "ffn": {"w_gate": (n, d, ff),
                                       "w_up": (n, d, ff),
                                       "w_down": (n, ff, d)}}}}
    if not cfg["tie_word_embeddings"]:
        tree["lm_head"] = (d, v)
    return tree


def _draw(name: str, shape, gen: torch.Generator, dtype,
          embed_std: Optional[float]) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    if name == "embed" and embed_std is not None:
        return x.mul_(embed_std)
    if name.endswith("ln"):
        return x.mul_(0.05).add_(1.0)
    if name in ("bq", "bk", "bv"):
        return x.mul_(0.05)
    return x.mul_(shape[-2] ** -0.5)


def make_params(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    dt = dtype_of(cfg)
    embed_std = cfg.get("init", {}).get("embed_std")

    def build(name, node):
        if isinstance(node, dict):
            return {k: build(k, v) for k, v in node.items()}
        if isinstance(node, list):
            return []
        return _draw(name, node, gen, dt, embed_std)

    return build("", leaf_shapes(cfg))


def layer(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves, flat: ``ln``, ``wq`` .. ``bv``, ``ffn_ln``,
    ``w_gate``, ``w_up``, ``w_down``."""
    blk = params["block"]["pos0"]
    out = {k: t[i] for k, t in blk["attn"].items()}
    out["ffn_ln"] = blk["ffn_ln"][i]
    out.update({k: t[i] for k, t in blk["ffn"].items()})
    return out


def leaves(tree: Any, prefix: str = ""):
    """``(path, tensor)`` pairs, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree
