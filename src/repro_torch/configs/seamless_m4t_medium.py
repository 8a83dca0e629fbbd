"""seamless-m4t-medium — enc-dec multimodal (audio) [arXiv:2308.11596].

12L encoder + 12L decoder, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=256206.  The speech frontend (mel-spectrogram + conv feature
extractor) is a stub per the assignment carve-out: ``input_specs()``
provides precomputed frame embeddings that feed the transformer encoder;
the decoder cross-attends to encoder output.
"""
from repro_torch.configs.base import AudioConfig, ModelConfig, register

register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,                  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
    audio=AudioConfig(
        embed_dim=1024,
        num_frames=512,
        encoder_layers=12,
    ),
    source="arXiv:2308.11596",
))
