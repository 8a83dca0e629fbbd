"""codeqwen1.5-7b — dense, Qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B].

32L, d_model=4096, 32 heads (MHA: kv=32), d_ff=13440, vocab=92416.
Qwen1.5 uses QKV bias and rope_theta=1e6 (code variant uses long context).
"""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B",
))
