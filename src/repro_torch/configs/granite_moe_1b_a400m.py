"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8. Granite multipliers (embedding/residual/
logits). [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    vocab_size=49_155,
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    moe_num_experts=32,
    moe_top_k=8,
    moe_d_ff=512,
    emb_multiplier=12.0,
    residual_multiplier=0.22,
    logits_multiplier=1.0 / 6.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=False,
)
