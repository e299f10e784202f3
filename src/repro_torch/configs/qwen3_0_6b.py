"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA, head_dim 128, untied head per Qwen3 family.
[hf:Qwen/Qwen3-0.6B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    vocab_size=151_936,
    d_model=1024,
    n_layers=28,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    mlp_kind="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=False,
)
