"""Model configuration — one dataclass covering all 10 assigned families.

Port of ``repro.models.config``, field for field (the module imports no
JAX; the port keeps its own copy so that it imports nothing of ``repro``).

Every architecture is expressed as a ``ModelConfig``; family-specific
behaviour is switched by ``block_pattern`` entries and feature flags, so the
transformer stack, the MoE dispatch, the SSM backbone and the RWKV recurrence
all share one substrate (embeddings, norms, residual wiring, losses).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Sequence

BlockKind = Literal["attn", "mamba2", "rwkv6", "shared_attn"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "vlm", "audio", "hybrid", "ssm"]
    vocab_size: int
    d_model: int
    n_layers: int
    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0          # stablelm partial rotary
    sliding_window: int | None = None   # local-attention window
    local_global_pattern: bool = False  # gemma2 alternating local/global
    post_block_norm: bool = False       # gemma2 sandwich norms
    norm_kind: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    # ---- mlp ----
    d_ff: int = 0
    mlp_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    # ---- moe ----
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                    # per-expert hidden
    moe_shared_d_ff: int = 0             # shared-expert hidden (qwen2-moe)
    moe_every: int = 1                   # MoE layer cadence (1 = all layers)
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # ---- ssm / hybrid ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0                  # zamba2: shared attn block cadence
    # ---- rwkv ----
    rwkv_head_size: int = 64
    # ---- enc-dec ----
    encoder_layers: int = 0              # >0 ⇒ encoder-decoder
    # ---- modality frontend stubs ----
    frontend: Literal["none", "vision", "audio"] = "none"
    frontend_tokens: int = 256           # vision patches per example (stub)
    # ---- misc ----
    tie_embeddings: bool = True
    emb_multiplier: float = 1.0          # granite scalers
    residual_multiplier: float = 1.0
    logits_multiplier: float = 1.0
    dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    # unroll all layer/chunk scans (XLA cost_analysis counts while bodies
    # ONCE; the roofline extrapolation compiles small unrolled variants —
    # see launch/dryrun.py)
    scan_unroll: bool = False
    # remat policy for the layer-scan checkpoint: "none" (save nothing) or
    # "dots" (save matmul outputs - trades HBM for recompute FLOPs)
    remat_policy: str = "none"
    # CE logits dtype: fp32 default; bf16 halves the (B,S,V) loss bytes at
    # a bounded logsumexp precision cost (§Perf variant)
    logits_dtype: str = "float32"

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def moe_experts_padded(self) -> int:
        """Expert count padded to a multiple of 16 so the expert axis shards
        over the production 'model' axis (qwen2-moe: 60 → 64; padded experts
        get -inf router logits and are never routed to)."""
        return (self.moe_num_experts + 15) // 16 * 16

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def block_kinds(self) -> list[str]:
        """Per-layer block kinds for the decoder stack."""
        if self.family == "ssm":
            return ["rwkv6"] * self.n_layers
        if self.family == "hybrid":
            kinds = []
            for i in range(self.n_layers):
                if self.attn_every and (i + 1) % self.attn_every == 0:
                    kinds.append("shared_attn")
                else:
                    kinds.append("mamba2")
            return kinds
        return ["attn"] * self.n_layers

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_num_experts > 0 and (i % self.moe_every == 0)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized sibling config (same family/flags, tiny dims)."""
        base = dict(
            n_layers=min(self.n_layers, 2 if self.encoder_layers == 0 else 2),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.head_dim else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            moe_num_experts=min(self.moe_num_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            moe_shared_d_ff=128 if self.moe_shared_d_ff else 0,
            encoder_layers=min(self.encoder_layers, 2),
            attn_every=2 if self.attn_every else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=32,
            frontend_tokens=min(self.frontend_tokens, 16),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )
        # MHA configs (kv == heads) keep that property when reduced
        if self.n_kv_heads and self.n_kv_heads == self.n_heads:
            base["n_kv_heads"] = base["n_heads"]
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
