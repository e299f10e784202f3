"""zamba2-1.2b [hybrid] — 38L d_model=2048, Mamba2 backbone (ssm_state=64,
head_dim 64, expand 2) with a SHARED full attention block (32H MHA) applied
every 6th layer: 6×(5 mamba + shared attn) + 2 mamba = 38 blocks, 32 Mamba2
+ 6 shared-attn applications.  d_ff=8192 feeds the shared block's MLP.
Sub-quadratic: the attention block uses a sliding window at long context,
so long_500k runs. [arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    vocab_size=32_000,
    d_model=2048,
    n_layers=38,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    mlp_kind="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    attn_every=6,
    sliding_window=4096,
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=True,
)
