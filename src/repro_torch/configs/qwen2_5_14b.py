"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA with QKV bias. [hf:Qwen/Qwen2.5-14B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    vocab_size=152_064,
    d_model=5120,
    n_layers=48,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13_824,
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    subquadratic=False,
)
