"""jamba-1.5-large-398b — hybrid Mamba+attention, MoE [arXiv:2403.19887].

72L in 9 groups of 8 (1 attention layer : 7 Mamba layers per group),
d_model=8192, 64 heads (GQA kv=8) on the attention layers,
MoE 16 experts top-2 (d_ff=24576) on every other layer, dense FFN
(d_ff=24576) otherwise.  vocab=65536, ssm_state=128 (Mamba blocks use the
SSD form — DESIGN.md §6 notes Jamba-1 used Mamba-1; we use Mamba-2/SSD
uniformly for the recurrent blocks).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=10_000.0,
    attn_every=8,                   # 1 attn per 8 layers (1:7 interleave)
    moe=MoEConfig(
        num_experts=16,
        experts_per_token=2,
        expert_d_ff=24576,
        moe_every=2,
        moe_offset=1,
    ),
    ssm=SSMConfig(
        state_dim=128,
        head_dim=64,
        expand=2,
        conv_width=4,
        chunk_size=256,
    ),
    source="arXiv:2403.19887",
))
