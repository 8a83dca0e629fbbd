"""glm4-9b — dense, RoPE + GQA [hf:THUDM/glm-4-9b].

40L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696, vocab=151552.
GLM-4 uses partial-rotary embeddings; we use full RoPE (noted in
DESIGN.md §6 — roofline-neutral).
"""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b",
))
