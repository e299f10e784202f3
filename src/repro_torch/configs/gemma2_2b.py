"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local+global alternating attention (window 4096), attn/final logit
softcapping, GeGLU, sandwich norms, √d embedding scaling, tied embeddings.
[arXiv:2408.00118; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    vocab_size=256_000,
    d_model=2304,
    n_layers=26,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    mlp_kind="geglu",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=True,
    post_block_norm=True,
    rope_theta=10_000.0,
    emb_multiplier=2304**0.5,
    tie_embeddings=True,
    subquadratic=False,
)
