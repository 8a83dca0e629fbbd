"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1].

64L, d_model=6144, 48 heads (GQA kv=8), expert d_ff=32768, vocab=131072.
Every layer is MoE (no shared experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=8,
        experts_per_token=2,
        expert_d_ff=32768,
    ),
    source="hf:xai-org/grok-1",
))
