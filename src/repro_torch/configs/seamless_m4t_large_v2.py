"""seamless-m4t-large-v2 [audio] — enc-dec transformer backbone: 24L
encoder + 24L decoder, d_model=1024 16H (kv=16, MHA) d_ff=8192
vocab=256206. The speech frontend (fbank/conformer feature extractor) is a
STUB: ``input_specs()`` provides precomputed frame embeddings for the
encoder. [arXiv:2308.11596; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    vocab_size=256_206,
    d_model=1024,
    n_layers=24,
    encoder_layers=24,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=10_000.0,
    frontend="audio",
    tie_embeddings=False,
    subquadratic=False,
)
