"""Attention: GQA with every variant the assigned archs need.

Port of ``repro.models.attention``.  Supports grouped-query attention (any
kv:q ratio incl. MHA), causal and sliding-window masks, gemma2 logit
softcapping, qwen3 qk-norm, qwen2.5 QKV bias, stablelm partial rotary,
cross-attention (enc-dec), decode with a preallocated KV cache, and the
two-buffer decode path with a bf16 or int8 prefix.

Layout: activations (B, S, D); heads live in (B, S, H, hd) and the logits
are contracted in fp32, as the reference's ``preferred_element_type``.

The cache append differs from the reference in one way: the reference's
``dynamic_update_slice`` returns a new buffer, the port writes the new K/V
into ``cache.k`` / ``cache.v`` IN PLACE (``index_copy_`` at
``cache.length``, start clamped into the buffer as ``dynamic_update_slice``
clamps it) and returns a ``KVCache`` over the same buffers with the new
length.  ``length`` stays a 0-d device tensor, so a decode step reads no
value on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense,
    dense_init,
    rmsnorm,
    rmsnorm_init,
    softcap,
)

NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KVH, hd)
    v: torch.Tensor  # (B, S_max, KVH, hd)
    length: torch.Tensor  # () int32 — tokens already cached


# fixed symmetric scale for int8 KV prefixes (the reference's constant)
KV_Q8_SCALE = 0.05


def attn_init(gen, cfg: ModelConfig, cross: bool = False, device=None) -> Params:
    d, ad, kvd = cfg.d_model, cfg.attn_dim, cfg.kv_dim
    p = {
        "wq": dense_init(gen, d, ad, bias=cfg.qkv_bias, device=device),
        "wk": dense_init(gen, d, kvd, bias=cfg.qkv_bias, device=device),
        "wv": dense_init(gen, d, kvd, bias=cfg.qkv_bias, device=device),
        "wo": dense_init(gen, ad, d, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _mask(q_pos, k_pos, window, causal: bool):
    """(Sq, Sk) additive mask in fp32.  ``window`` is None (no window) or
    an int where ≤ 0 means "global" (gemma2's alternating layers)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None and window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG)


def append_kv(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> KVCache:
    """Write ``k``/``v`` (B, s, KVH, hd) into the cache buffers at
    ``cache.length`` IN PLACE; returns the cache with ``length + s``.  The
    start is clamped to ``[0, S_max - s]``, as ``dynamic_update_slice``
    clamps it; the position stays on the device."""
    s, s_max = k.shape[1], cache.k.shape[1]
    start = torch.clamp(cache.length, 0, s_max - s)
    idx = start.long() + torch.arange(s, device=cache.k.device)
    cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
    cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
    return KVCache(cache.k, cache.v, cache.length + s)


def multihead_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    window: int | None = None,
    causal: bool = True,
    cache: KVCache | None = None,
    memory: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
):
    """Returns (out, new_cache).

    Train/prefill: cache=None → full (S, S) masked attention.
    Decode: cache given, x is (B, s, D); K/V appended in place.
    Cross-attn: memory (B, Sm, D) given → K/V from memory, no mask.
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = _split_heads(dense(p["wq"], x), h, hd)
    kv_src = memory if memory is not None else x
    k = _split_heads(dense(p["wk"], kv_src), kvh, hd)
    v = _split_heads(dense(p["wv"], kv_src), kvh, hd)

    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)

    if memory is None:  # self-attention → rope
        if positions is None:
            ar = torch.arange(s, device=x.device)[None, :]
            positions = cache.length + ar if cache is not None else ar
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    new_cache = None
    if cache is not None:
        new_cache = append_kv(cache, k, v)
        k, v = new_cache.k, new_cache.v

    # GQA: fold q heads as (kvh, rep) and contract against UNEXPANDED K/V
    rep = h // kvh
    sq, sk = q.shape[1], k.shape[1]
    qg = q.reshape(b, sq, kvh, rep, hd)

    scale = hd ** -0.5
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    logits = softcap(logits, cfg.attn_logit_softcap)

    if memory is None:
        q_pos = (positions[0] if positions.dim() > 1 else positions).to(torch.int32)
        k_pos = torch.arange(sk, dtype=torch.int32, device=x.device)
        m = _mask(q_pos, k_pos, window, causal)
        if cache is not None:  # never attend beyond written length
            m = m + torch.where(k_pos[None, :] < cache.length + s, 0.0, NEG)
        logits = logits + m[None, None, None, :, :]

    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(x.dtype))
    out = dense(p["wo"], out.reshape(b, sq, h * hd))
    return out, new_cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_len, cfg.n_kv_heads, cfg.head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, cfg.n_kv_heads, cfg.head_dim), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def twobuf_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, 1, D) — decode only
    prefix: KVCache,          # frozen prefix
    tail: KVCache,            # small buffer; new tokens append here (in place)
    *,
    window=None,
):
    """Two-buffer decode attention: a read-only prefix and a small tail the
    new token appends to, combined flash-decoding style (per-buffer max,
    Σexp and Σw·V, then merged).  Returns (out, new_tail)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("two-buffer path is decode-only")
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = h // kvh

    q = _split_heads(dense(p["wq"], x), h, hd)
    k = _split_heads(dense(p["wk"], x), kvh, hd)
    v = _split_heads(dense(p["wv"], x), kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)

    q_pos = prefix.length + tail.length  # absolute position of this token
    pos = q_pos + torch.arange(1, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)

    new_tail = append_kv(tail, k, v)  # the prefix is never written
    tk, tv = new_tail.k, new_tail.v

    qg = q.reshape(b, 1, kvh, rep, hd)
    scale = hd ** -0.5

    def _mask2(lg, base_pos, valid_len, klen):
        kpos = base_pos + torch.arange(klen, dtype=torch.int32, device=x.device)
        ok = kpos[None, :] <= q_pos
        ok &= kpos[None, :] < base_pos + valid_len
        if window is not None and window > 0:
            ok &= kpos[None, :] > q_pos - window
        return lg + torch.where(ok, 0.0, NEG)[None, None, None, :, :]

    def masked_logits(keys, base_pos, valid_len):
        lg = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), keys.float()) * scale
        lg = softcap(lg, cfg.attn_logit_softcap)
        return _mask2(lg, base_pos, valid_len, keys.shape[1])

    if prefix.k.dtype == torch.int8:
        # W8A8 prefix: q quantized per head to int8, contracted against the
        # int8 keys.  The reference contracts int8×int8 into int32; here the
        # product runs in float32 on the int8 VALUES, which is exact: every
        # |q|, |k| <= 127 and head_dim <= 256, so each partial sum stays
        # below 127 · 127 · 256 < 2^24, where float32 holds integers exactly.
        qmax = torch.amax(torch.abs(qg.float()), dim=-1, keepdim=True) + 1e-8
        q_q8 = torch.clamp(torch.round(qg.float() / qmax * 127.0), -127, 127)
        lg_i = torch.einsum("bqgrd,bkgd->bgrqk", q_q8, prefix.k.float())
        qs = qmax.reshape(b, 1, kvh, rep, 1).permute(0, 2, 3, 1, 4)
        lg = lg_i * (qs / 127.0) * KV_Q8_SCALE * scale
        lg = softcap(lg, cfg.attn_logit_softcap)
        lp = _mask2(lg, 0, prefix.length, prefix.k.shape[1])
        pv_int8 = True
    else:
        lp = masked_logits(prefix.k, 0, prefix.length)      # (b,g,r,1,Sp)
        pv_int8 = False
    lt = masked_logits(tk, prefix.length, new_tail.length)  # (b,g,r,1,St)

    m = torch.maximum(torch.amax(lp, dim=-1, keepdim=True),
                      torch.amax(lt, dim=-1, keepdim=True))
    wp = torch.exp(lp - m)
    wt = torch.exp(lt - m)
    denom = torch.sum(wp, dim=-1, keepdim=True) + torch.sum(wt, dim=-1, keepdim=True)
    if pv_int8:
        op = torch.einsum("bgrqk,bkgd->bqgrd", wp, prefix.v.float())
        op = (op * KV_Q8_SCALE).to(x.dtype)
    else:
        op = torch.einsum("bgrqk,bkgd->bqgrd", wp.to(x.dtype), prefix.v.to(x.dtype))
    ot = torch.einsum("bgrqk,bkgd->bqgrd", wt.to(x.dtype), tv.to(x.dtype))
    out = (op + ot) / denom.permute(0, 3, 1, 2, 4).to(x.dtype)
    out = dense(p["wo"], out.reshape(b, 1, h * hd))
    return out, new_tail
