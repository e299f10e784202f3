"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352 — partial rotary (25%), LayerNorm, untied embeddings.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    vocab_size=100_352,
    d_model=2048,
    n_layers=24,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    mlp_kind="swiglu",
    norm_kind="layernorm",
    rope_fraction=0.25,
    rope_theta=10_000.0,
    tie_embeddings=False,
    subquadratic=False,
)
