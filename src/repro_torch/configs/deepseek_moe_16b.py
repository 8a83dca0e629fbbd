"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066].

28L, d_model=2048, 16 heads (kv=16), vocab=102400.
64 routed experts top-6 + 2 shared experts, per-expert d_ff=1408.
Layer 0 is a conventional dense FFN (d_ff=10944) per the paper.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                     # dense layers' width (layer 0)
    vocab_size=102400,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        expert_d_ff=1408,
        first_k_dense=1,
        dense_d_ff=10944,
    ),
    source="arXiv:2401.06066",
))
