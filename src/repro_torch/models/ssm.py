"""Mamba2 (SSD) block — the zamba2 backbone.

Port of ``repro.models.ssm``.  Chunked state-space-duality formulation:
within a chunk the output is a masked quadratic attention-like product;
across chunks a Python loop over chunks (the reference's ``lax.scan``,
``ssm.py:157``) carries the (H, hd, N) state.  Decode is a single-token
state update (O(1) per step) with the conv tail and SSM state carried in
``SSMCache``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    chunk_runs,
    dense,
    dense_init,
    randn,
    rmsnorm,
    rmsnorm_init,
)


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner + 2*N) conv tail
    state: torch.Tensor  # (B, H, hd, N) SSM state


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    h = d_inner // hd
    n = cfg.ssm_state
    return d_inner, h, hd, n


def mamba2_init(gen, cfg: ModelConfig, device=None) -> Params:
    """Projections split per component (z/x/B/C/dt), as in the reference."""
    d = cfg.d_model
    d_inner, h, hd, n = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": dense_init(gen, d, d_inner, device=device),
        "in_x": dense_init(gen, d, d_inner, device=device),
        "in_B": dense_init(gen, d, n, device=device),
        "in_C": dense_init(gen, d, n, device=device),
        "in_dt": dense_init(gen, d, h, device=device),
        "conv_x": randn(gen, (cfg.ssm_conv, d_inner), device, 0.2),
        "conv_x_b": torch.zeros((d_inner,), **f32),
        "conv_B": randn(gen, (cfg.ssm_conv, n), device, 0.2),
        "conv_B_b": torch.zeros((n,), **f32),
        "conv_C": randn(gen, (cfg.ssm_conv, n), device, 0.2),
        "conv_C_b": torch.zeros((n,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h, **f32))),
        "norm": rmsnorm_init(d_inner, device),
        "out_proj": dense_init(gen, d_inner, d, device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv1d, width K: (B,S,C) with optional carried tail
    (B,K-1,C). Returns (out, new_tail)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([tail, xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + xp[:, i: i + xbc.shape[1], :] * w[i].to(xbc.dtype)
    out = out + b.to(xbc.dtype)
    new_tail = xp[:, xp.shape[1] - (k - 1):, :]
    return F.silu(out), new_tail


def mamba2_block(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: SSMCache | None = None):
    """(B, S, D) → (B, S, D). Train/prefill uses the chunked SSD loop;
    S==1 with cache uses the O(1) decode update."""
    b, s, d = x.shape
    d_inner, h, hd, n = _dims(cfg)

    z = dense(p["in_z"], x)
    xr = dense(p["in_x"], x)
    braw = dense(p["in_B"], x)
    craw = dense(p["in_C"], x)
    dt = dense(p["in_dt"], x)
    tails = cache.conv if cache is not None else None

    def tail_slice(lo, hi):
        return tails[:, :, lo:hi] if tails is not None else None

    xr, t_x = _causal_conv(xr, p["conv_x"], p["conv_x_b"], tail_slice(0, d_inner))
    bmat, t_b = _causal_conv(braw, p["conv_B"], p["conv_B_b"], tail_slice(d_inner, d_inner + n))
    cmat, t_c = _causal_conv(craw, p["conv_C"], p["conv_C_b"], tail_slice(d_inner + n, d_inner + 2 * n))
    new_tail = torch.cat([t_x, t_b, t_c], dim=-1)
    xh = xr.reshape(b, s, h, hd)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["A_log"])                   # (H,)
    da = dt * a  # (B,S,H) log-decay per step
    dbx = torch.einsum("bsh,bsn,bshd->bshdn", dt.to(x.dtype), bmat, xh)

    if cache is not None and s == 1:
        # decode: state ← exp(da)·state + dt·B⊗x ; y = C·state + D·x
        st = cache.state * torch.exp(da)[:, 0, :, None, None].to(cache.state.dtype)
        st = st + dbx[:, 0].to(cache.state.dtype)
        y = torch.einsum("bhdn,bn->bhd", st, cmat[:, 0].to(st.dtype)) \
            + p["D"].to(x.dtype)[None, :, None] * xh[:, 0]
        y = y.reshape(b, 1, d_inner).to(x.dtype)
        out = dense(p["out_proj"], rmsnorm(p["norm"], y * F.silu(z)))
        return out, SSMCache(new_tail, st)

    # ---- chunked SSD: chunks of ``ssm_chunk`` steps, and a last, shorter
    # chunk where s is not a multiple of it (the reference refuses such an
    # s: ROADMAP §3 fault 14) ----
    st = cache.state if cache is not None else torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for lo, hi, c in chunk_runs(s, cfg.ssm_chunk):
        y_run, st = _ssd_chunks(da[:, lo:hi], xh[:, lo:hi], bmat[:, lo:hi], cmat[:, lo:hi],
                                dt[:, lo:hi], st, c)
        ys.append(y_run)
    y = torch.cat(ys, dim=1)
    y = y + p["D"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(b, s, d_inner)
    out = dense(p["out_proj"], rmsnorm(p["norm"], y * F.silu(z)))
    new_cache = SSMCache(new_tail, st) if cache is not None else None
    return out, new_cache


def _ssd_chunks(da, xh, bmat, cmat, dt, st, c: int):
    """The chunked SSD over ``da``, ``dt`` (b, s, h), ``xh`` (b, s, h, hd),
    ``bmat``, ``cmat`` (b, s, n), s a multiple of ``c``, from the state
    ``st`` (b, h, hd, n): returns (y (b, s, h, hd) in ``xh``'s dtype, without
    the D·x skip, and the state after the last step)."""
    b, s, h, hd = xh.shape
    n = bmat.shape[-1]
    nc = s // c
    dac = da.reshape(b, nc, c, h)
    cum = torch.cumsum(dac, dim=2)                     # within-chunk cumulative decay
    xc = xh.reshape(b, nc, c, h, hd)
    bc_ = bmat.reshape(b, nc, c, n)
    cc_ = cmat.reshape(b, nc, c, n)
    dtc = dt.reshape(b, nc, c, h)

    # intra-chunk (quadratic in c): y_intra[t] = Σ_{u≤t} C_t·B_u exp(cum_t-cum_u) dt_u x_u.
    # The mask goes on the exponent, before the exp: for u > t, cum_t − cum_u
    # is a positive sum of decays whose exp overflows at published widths, and
    # the reference's where after the exp sends 0 · inf = NaN into every
    # gradient of the block (ROADMAP §3 fault 12).  The values are the same.
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None],
                                  cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                  float("-inf")))  # (b,nc,t,u,h)
    scores = torch.einsum("bztn,bzun->bztu", cc_, bc_)[..., None] * decay  # (b,nc,t,u,h)
    y_intra = torch.einsum("bztuh,bzuh,bzuhd->bzthd", scores.to(xh.dtype), dtc.to(xh.dtype), xc)

    # inter-chunk: carry the state with a loop over chunks
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b,nc,h) total decay of chunk
    tail_decay = torch.exp(cum[:, :, -1:, :] - cum)  # (b,nc,c,h)
    dstate = torch.einsum("bzch,bzcn,bzchd->bzhdn", (dtc * tail_decay).to(xh.dtype), bc_, xc)

    y_inter = []
    for zi in range(nc):  # the reference's lax.scan over chunks
        cseq = cc_[:, zi]
        y_inter.append(torch.einsum("bcn,bch,bhdn->bchd", cseq, torch.exp(cum[:, zi]).to(cseq.dtype),
                                    st.to(cseq.dtype)))
        st = st * chunk_decay[:, zi, :, None, None].to(st.dtype) + dstate[:, zi].to(st.dtype)
    y_inter = torch.stack(y_inter, dim=1)  # (b,nc,c,h,hd)
    return (y_intra + y_inter.to(xh.dtype)).reshape(b, s, h, hd), st


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> SSMCache:
    d_inner, h, hd, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        state=torch.zeros((batch, h, hd, n), dtype=torch.float32, device=device),
    )
