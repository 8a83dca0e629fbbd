"""mamba2-780m — attention-free SSM, SSD algorithm [arXiv:2405.21060].

48L, d_model=1536, ssm_state=128, expand=2 (d_inner=3072), head_dim=64
(48 ssm heads), conv width 4, vocab=50280.  No attention, no FFN block
(the Mamba block is the whole layer).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=1,
    tie_embeddings=True,
    ssm=SSMConfig(
        state_dim=128,
        head_dim=64,
        expand=2,
        conv_width=4,
        chunk_size=256,
    ),
    source="arXiv:2405.21060",
))
