"""The plain reference against NumPy on a tiny seeded case, and against the
program's own forward and training step at a small size on the CPU."""
import numpy as np
import pytest
import torch

from bench.common import BENCH, load_json
from bench.reference import dense_lm
from bench.weights import (layer, leaf_shapes, leaves, make_params,
                           program_config)

CFG = {"hidden_size": 16, "intermediate_size": 24, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 4,
       "vocab_size": 32, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
       "qkv_bias": True, "tie_word_embeddings": False,
       "torch_dtype": "float32"}


def numpy_logits(params, cfg, toks):
    """The same model written out in NumPy float64."""
    p = {k: v.double().numpy() for k, v in leaves(params)}
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    eps, s = cfg["rms_norm_eps"], len(toks)

    def norm(x, w):
        return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * w

    def rope(x):
        half = hd // 2
        inv = cfg["rope_theta"] ** (-np.arange(half) / half)
        ang = np.arange(s)[:, None] * inv[None]
        c, si = np.cos(ang)[:, None], np.sin(ang)[:, None]
        a, b = x[..., :half], x[..., half:]
        return np.concatenate([a * c - b * si, a * si + b * c], -1)

    x = p["embed"][toks]
    for i in range(cfg["num_hidden_layers"]):
        g = {k.split("/")[-1]: v[i] for k, v in p.items()
             if k.startswith("block/")}
        hn = norm(x, g["ln"])
        q = rope((hn @ g["wq"] + g["bq"]).reshape(s, h, hd))
        k = rope((hn @ g["wk"] + g["bk"]).reshape(s, hkv, hd))
        v = (hn @ g["wv"] + g["bv"]).reshape(s, hkv, hd)
        out = np.zeros((s, h, hd))
        for j in range(h):
            kk, vv = k[:, j // (h // hkv)], v[:, j // (h // hkv)]
            sc = q[:, j] @ kk.T / np.sqrt(hd)
            sc = np.where(np.tril(np.ones((s, s))) > 0, sc, -np.inf)
            w = np.exp(sc - sc.max(-1, keepdims=True))
            out[:, j] = (w / w.sum(-1, keepdims=True)) @ vv
        x = x + out.reshape(s, h * hd) @ g["wo"]
        hn = norm(x, g["ffn_ln"])
        a = hn @ g["w_gate"]
        x = x + ((a / (1 + np.exp(-a))) * (hn @ g["w_up"])) @ g["w_down"]
    return norm(x, p["final_ln"]) @ p["lm_head"]


def test_served_logits_match_numpy():
    params = make_params(CFG, 3, torch.device("cpu"))
    toks = [5, 1, 30, 7, 7, 2, 19, 0, 11]
    want = numpy_logits(params, CFG, toks)
    got = dense_lm.served_logits(params, CFG, [toks], [range(9)])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    rows = dense_lm.served_logits(params, CFG, [toks[:5], toks], [[4], [2, 8]])
    np.testing.assert_allclose(rows[0].numpy()[0], want[4], atol=1e-4)
    np.testing.assert_allclose(rows[1].numpy(), want[[2, 8]], atol=1e-5)


def test_fp8_control_moves_the_logits():
    params = make_params(CFG, 3, torch.device("cpu"))
    toks = [list(range(12))]
    ref = dense_lm.served_logits(params, CFG, toks, [range(12)])[0]
    low = dense_lm.served_logits(params, CFG, toks, [range(12)],
                                 quant="fp8")[0]
    gap = (ref - low).abs().max().item()
    assert 1e-3 < gap < 1.0


@pytest.mark.parametrize("tied", [False, True])
def test_reference_matches_the_program(tied):
    from repro_torch.models.model import Model
    full = program_config(load_json(
        BENCH / "configs" / ("qwen2-0.5b.json" if tied
                             else "codeqwen1.5-7b.json")))
    pc = full.reduced(tie_embeddings=tied)
    cfg = dict(CFG, hidden_size=pc.d_model, intermediate_size=pc.d_ff,
               num_hidden_layers=pc.num_layers,
               num_attention_heads=pc.num_heads,
               num_key_value_heads=pc.num_kv_heads, head_dim=pc.head_dim,
               vocab_size=pc.vocab_size, rope_theta=pc.rope_theta,
               rms_norm_eps=pc.rms_eps, tie_word_embeddings=tied)
    params = make_params(cfg, 2**33 + 1, torch.device("cpu"))
    shapes = {k: tuple(v.shape) for k, v in
              leaves(Model(pc).init_shapes())}
    assert shapes == {k: tuple(v.shape) for k, v in leaves(params)}
    toks = torch.tensor([[3, 9, 200, 17, 17, 4, 250, 1]])
    with torch.no_grad():
        prog = Model(pc).apply(params, toks, mode="train").logits[0]
    ref = dense_lm.served_logits(params, cfg, [toks[0].tolist()],
                                 [range(8)])[0]
    np.testing.assert_allclose(ref.numpy(), prog.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_layer_view_and_shapes():
    params = make_params(CFG, 1, torch.device("cpu"))
    assert set(layer(params, 1)) == {"ln", "wq", "wk", "wv", "wo", "bq",
                                     "bk", "bv", "ffn_ln", "w_gate", "w_up",
                                     "w_down"}
    assert leaf_shapes(CFG)["block"]["pos0"]["ffn"]["w_down"] == (2, 24, 16)
    a = make_params(CFG, 1, torch.device("cpu"))
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(leaves(a), leaves(params)))
