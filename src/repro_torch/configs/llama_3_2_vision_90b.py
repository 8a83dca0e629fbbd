"""llama-3.2-vision-90b — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision, scaled to the 90B numbers].

100L (80 self-attn + 20 cross-attn, one per 5), d_model=8192, 64 heads
(GQA kv=8), d_ff=28672, vocab=128256.  The vision tower (ViT) is a stub per
the assignment carve-out: ``input_specs()`` provides precomputed patch
embeddings (1280-dim, 576 tokens/image); a learned projector maps them to
d_model and the cross-attn layers attend to them.
"""
from repro_torch.configs.base import ModelConfig, VisionConfig, register

register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    vision=VisionConfig(
        embed_dim=1280,
        num_image_tokens=576,
        cross_attn_every=5,
    ),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
