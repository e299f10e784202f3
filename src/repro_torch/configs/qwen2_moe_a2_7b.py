"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + shared expert (4×1408=5632 hidden,
sigmoid-gated). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    vocab_size=151_936,
    d_model=2048,
    n_layers=24,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    qkv_bias=True,
    moe_num_experts=60,
    moe_top_k=4,
    moe_d_ff=1408,
    moe_shared_d_ff=5632,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    subquadratic=False,
)
