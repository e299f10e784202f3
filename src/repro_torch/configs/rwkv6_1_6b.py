"""rwkv6-1.6b [ssm] — Finch: 24L d_model=2048 (attention-free, head_size 64
⇒ 32 heads), channel-mix d_ff=7168, vocab=65536. Data-dependent decay WKV6
recurrence, O(1) decode state ⇒ long_500k runs. [arXiv:2404.05892;
unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    vocab_size=65_536,
    d_model=2048,
    n_layers=24,
    d_ff=7168,
    rwkv_head_size=64,
    ssm_chunk=128,
    tie_embeddings=False,
    subquadratic=True,
)
