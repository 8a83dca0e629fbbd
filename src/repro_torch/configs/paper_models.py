"""The paper's own evaluation models (Table 1), as CPU-runnable toy variants.

The paper benchmarks Qwen3 (0.6B–30B-A3B MoE), Llama-3.2 (1B/3B), Gemma-3-4B,
Nemotron-30B-A3B and Qwen3-VL on an M4 Max.  These are *architecturally
faithful, width-reduced* variants of each family: same family code path
(dense GQA / MoE / VLM) at sizes a CPU test can run.  The registry is a copy
of the reference package's, so both packages resolve the same names.

The '-toy' suffix marks them as benchmark stand-ins, not assigned archs.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, VisionConfig, register

# Qwen3-0.6B stand-in: dense GQA, the paper's fastest model.
register(ModelConfig(
    name="qwen3-0.6b-toy", family="dense", num_layers=4, d_model=256,
    num_heads=8, num_kv_heads=4, d_ff=768, vocab_size=4096, qkv_bias=False,
    rope_theta=1_000_000.0, tie_embeddings=True, dtype="float32",
    source="arXiv:2505.09388 (toy)",
))

# Qwen3-4B stand-in (deeper/wider than 0.6B toy — preserves the size ordering).
register(ModelConfig(
    name="qwen3-4b-toy", family="dense", num_layers=8, d_model=512,
    num_heads=8, num_kv_heads=4, d_ff=1536, vocab_size=4096,
    rope_theta=1_000_000.0, dtype="float32", source="arXiv:2505.09388 (toy)",
))

# Qwen3-8B stand-in.
register(ModelConfig(
    name="qwen3-8b-toy", family="dense", num_layers=12, d_model=640,
    num_heads=10, num_kv_heads=2, d_ff=2048, vocab_size=4096,
    rope_theta=1_000_000.0, dtype="float32", source="arXiv:2505.09388 (toy)",
))

# Qwen3-30B-A3B stand-in: MoE, 8 experts top-2 (paper: 128e top-8 — reduced).
register(ModelConfig(
    name="qwen3-30b-a3b-toy", family="moe", num_layers=6, d_model=384,
    num_heads=6, num_kv_heads=2, d_ff=1024, vocab_size=4096,
    rope_theta=1_000_000.0, dtype="float32",
    moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=512),
    source="arXiv:2505.09388 (toy)",
))

# Llama-3.2-1B stand-in.
register(ModelConfig(
    name="llama-3.2-1b-toy", family="dense", num_layers=6, d_model=320,
    num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=4096,
    rope_theta=500_000.0, tie_embeddings=True, dtype="float32",
    source="arXiv:2407.21783 (toy)",
))

# Llama-3.2-3B stand-in.
register(ModelConfig(
    name="llama-3.2-3b-toy", family="dense", num_layers=10, d_model=448,
    num_heads=8, num_kv_heads=2, d_ff=1408, vocab_size=4096,
    rope_theta=500_000.0, dtype="float32", source="arXiv:2407.21783 (toy)",
))

# Gemma-3-4B stand-in (sliding-window variant exercised).
register(ModelConfig(
    name="gemma3-4b-toy", family="dense", num_layers=8, d_model=512,
    num_heads=8, num_kv_heads=4, d_ff=1536, vocab_size=4096,
    rope_theta=10_000.0, sliding_window=256, dtype="float32",
    source="Gemma 3 TR (toy)",
))

# Nemotron-30B-A3B stand-in: MoE.
register(ModelConfig(
    name="nemotron-30b-a3b-toy", family="moe", num_layers=8, d_model=448,
    num_heads=8, num_kv_heads=4, d_ff=1280, vocab_size=4096,
    rope_theta=10_000.0, dtype="float32",
    moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=640),
    source="hf:nvidia/Nemotron-3-Nano-30B-A3B (toy)",
))

# Qwen3-VL stand-in: VLM with cross-attn image layers, used by the
# multimodal cache benchmarks (Tables 2-6).
register(ModelConfig(
    name="qwen3-vl-toy", family="vlm", num_layers=6, d_model=384,
    num_heads=6, num_kv_heads=2, d_ff=1152, vocab_size=4096,
    rope_theta=1_000_000.0, dtype="float32",
    vision=VisionConfig(embed_dim=192, num_image_tokens=64, cross_attn_every=3),
    source="arXiv:2409.12191 (toy)",
))
