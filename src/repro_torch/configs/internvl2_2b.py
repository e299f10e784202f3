"""internvl2-2b [vlm] — InternLM2-1.8B backbone: 24L d_model=2048 16H
(GQA kv=8) d_ff=8192 vocab=92553. The InternViT frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings that replace the
first ``frontend_tokens`` positions. [arXiv:2404.16821; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    vocab_size=92_553,
    d_model=2048,
    n_layers=24,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,
    tie_embeddings=False,
    subquadratic=False,
)
