"""RWKV-6 "Finch" block: data-dependent-decay linear attention + channel mix.

Port of ``repro.models.rwkv``.  The chunked linear-attention form: within a
chunk the contribution is a masked (decay-weighted) quadratic product;
across chunks an (H, K, V) state is carried by a Python loop over chunks
(the reference's ``lax.scan``, ``rwkv.py:151``; ROADMAP §2 B does not
queue a kernel for it).  Decode is an O(1) per-token state update
(``RWKVCache``).  The reference's simplifications are kept as they are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, chunk_runs, dense, dense_init, rmsnorm, rmsnorm_init


class RWKVCache(NamedTuple):
    last_x_att: torch.Tensor  # (B, D) previous token (attention mix)
    last_x_ffn: torch.Tensor  # (B, D) previous token (channel mix)
    state: torch.Tensor       # (B, H, K, V) wkv state


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv_head_size
    h = cfg.d_model // hd
    return h, hd


def rwkv6_init(gen, cfg: ModelConfig, device=None) -> Params:
    d = cfg.d_model
    h, hd = _dims(cfg)
    lora = max(32, d // 32)

    def full(v):
        return torch.full((d,), v, dtype=torch.float32, device=device)

    return {
        "mix_r": full(0.5),
        "mix_k": full(0.5),
        "mix_v": full(0.5),
        "mix_w": full(0.5),
        "wr": dense_init(gen, d, d, device=device),
        "wk": dense_init(gen, d, d, device=device),
        "wv": dense_init(gen, d, d, device=device),
        "wg": dense_init(gen, d, d, device=device),
        "wo": dense_init(gen, d, d, device=device),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-6.0),
        "wA": dense_init(gen, d, lora, scale=0.02, device=device),
        "wB": dense_init(gen, lora, d, scale=0.02, device=device),
        "u": torch.zeros((h, hd), dtype=torch.float32, device=device),  # per-head bonus
        "ln_x": rmsnorm_init(d, device),
        # channel mix
        "mix_kc": full(0.5),
        "wk_c": dense_init(gen, d, cfg.d_ff, device=device),
        "wv_c": dense_init(gen, cfg.d_ff, d, device=device),
        "wr_c": dense_init(gen, d, d, device=device),
    }


def _token_shift(x, last):
    """shift(x)[t] = x[t-1]; position 0 takes `last` (cache) or zeros."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def rwkv6_time_mix(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: RWKVCache | None):
    b, s, d = x.shape
    h, hd = _dims(cfg)
    last = cache.last_x_att if cache is not None else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, last)

    def mix(m):
        return x + (xs - x) * p[m].to(x.dtype)

    r = dense(p["wr"], mix("mix_r")).reshape(b, s, h, hd)
    k = dense(p["wk"], mix("mix_k")).reshape(b, s, h, hd)
    v = dense(p["wv"], mix("mix_v")).reshape(b, s, h, hd)
    g = F.silu(dense(p["wg"], mix("mix_r")))
    # data-dependent decay (the Finch signature)
    wx = mix("mix_w")
    logw = p["w0"].float() + dense(p["wB"], torch.tanh(dense(p["wA"], wx))).float()
    w = torch.exp(-torch.exp(logw)).reshape(b, s, h, hd)  # decay ∈ (0,1)
    u = p["u"].float()

    if cache is not None and s == 1:
        st = cache.state  # (B,H,K,V)
        kk, vv, rr = k[:, 0], v[:, 0], r[:, 0]
        kv = torch.einsum("bhk,bhv->bhkv", kk.float(), vv.float())
        y = torch.einsum("bhk,bhkv->bhv", rr.float(), st + u[None, :, :, None] * kv)
        st = st * w[:, 0].float()[..., None] + kv
        y = y.reshape(b, 1, d).to(x.dtype)
        out = dense(p["wo"], rmsnorm(p["ln_x"], y) * g)
        return out, RWKVCache(x[:, -1, :], cache.last_x_ffn, st)

    # ---- chunked form over the sequence (see the reference for the
    # factorization of the intra-chunk decay): chunks of ``ssm_chunk``
    # steps, and a last, shorter chunk where s is not a multiple of it (the
    # reference refuses such an s: ROADMAP §3 fault 14) ----
    st = cache.state if cache is not None else torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    ys = []
    logw = logw.reshape(b, s, h, hd)
    for lo, hi, c in chunk_runs(s, cfg.ssm_chunk):
        y_run, st = _wkv_chunks(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi], logw[:, lo:hi], u, st, c)
        ys.append(y_run)
    y = torch.cat(ys, dim=1).reshape(b, s, d).to(x.dtype)
    out = dense(p["wo"], rmsnorm(p["ln_x"], y) * g)
    new_cache = RWKVCache(x[:, -1, :], cache.last_x_ffn, st) if cache is not None else None
    return out, new_cache


def _wkv_chunks(r, k, v, logw, u, st, c: int):
    """The chunked WKV over ``r``, ``k``, ``v``, ``logw`` (b, s, h, hd),
    s a multiple of ``c``, from the state ``st`` (b, h, hd, hd): returns
    (y (b, s, h, hd) float32, the state after the last step)."""
    b, s, h, hd = r.shape
    nc = s // c
    logdecay = -torch.exp(logw).reshape(b, nc, c, h, hd)
    cum = torch.cumsum(logdecay, dim=2)   # inclusive: Σ_{j≤t} ℓ_j
    cum_ex = cum - logdecay               # exclusive: Σ_{j<t} ℓ_j

    rc = r.reshape(b, nc, c, h, hd).float()
    kc = k.reshape(b, nc, c, h, hd).float()
    vc = v.reshape(b, nc, c, h, hd).float()

    r_dec = rc * torch.exp(cum_ex)                          # r_t ⊙ e^{cum_ex[t]}
    k_dec = kc * torch.exp(torch.clamp(-cum, max=30.0))     # k_u ⊙ e^{−cum[u]}

    mask_lt = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.einsum("bzthk,bzuhk->bztuh", r_dec, k_dec)
    att = torch.where(mask_lt[None, None, :, :, None], att, 0.0)
    y_intra = torch.einsum("bztuh,bzuhv->bzthv", att, vc)
    # diagonal bonus term (u): r_t·(u ⊙ k_t) v_t
    diag = torch.einsum("bzthk,bzthk->bzth", rc, u[None, None, None] * kc)
    y_intra = y_intra + diag[..., None] * vc

    # inter-chunk state carry
    chunk_decay = torch.exp(cum[:, :, -1])                  # (b,nc,h,hd)
    tail = torch.exp(cum[:, :, -1:, :, :] - cum)            # decay u→chunk end
    dstate = torch.einsum("bzuhk,bzuhv->bzhkv", kc * tail, vc)

    y_inter = []
    for z in range(nc):  # the reference's lax.scan over chunks
        y_inter.append(torch.einsum("bthk,bhkv->bthv", r_dec[:, z], st))
        st = st * chunk_decay[:, z][..., None] + dstate[:, z]
    y_inter = torch.stack(y_inter, dim=1)
    return (y_intra + y_inter).reshape(b, s, h, hd), st


def rwkv6_channel_mix(p: Params, x: torch.Tensor, cache: RWKVCache | None):
    b, s, d = x.shape
    last = cache.last_x_ffn if cache is not None else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, last)
    xk = x + (xs - x) * p["mix_kc"].to(x.dtype)
    k = torch.square(torch.relu(dense(p["wk_c"], xk)))
    v = dense(p["wv_c"], k)
    r = torch.sigmoid(dense(p["wr_c"], xk).float()).to(x.dtype)
    out = r * v
    new_cache = cache._replace(last_x_ffn=x[:, -1, :]) if cache is not None else None
    return out, new_cache


def make_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> RWKVCache:
    h, hd = _dims(cfg)
    return RWKVCache(
        last_x_att=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        last_x_ffn=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        state=torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
    )
