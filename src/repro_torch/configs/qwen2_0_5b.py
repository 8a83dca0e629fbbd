"""qwen2-0.5b — dense, GQA with QKV bias [arXiv:2407.10671].

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151936.
head_dim = 896/14 = 64.  Embeddings tied (0.5B variant).
"""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
))
