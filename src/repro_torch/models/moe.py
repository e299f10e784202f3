"""Mixture-of-Experts with group-by-powered dispatch.

Port of ``repro.models.moe`` (its single-device dispatch).  MoE routing
**is** a GROUP BY: tokens are grouped by expert id and each group is
aggregated through its expert.

* ``route``: the per-expert histogram is a GROUP BY expert COUNT with the
  onehot strategy (the reference's one-hot sum, ``moe.py:72-73``), here one
  call of the ported segment kernel (``kernels.segment_agg``, kind count,
  strategy onehot) with the expert ids as tickets.  Its float32 counts are
  exact below 2^24 rows.
* ``moe_mlp_dense``: sort-based dispatch — a stable argsort of the
  (token, slot) assignments by expert id (a radix partition), a gather,
  and the expert FFNs as grouped matmuls over the contiguous runs
  (``kernels.grouped_matmul``, kernel B3, in place of ``jax.lax.ragged_dot``,
  ``moe.py:109-112``).  ``group_sizes`` stays on the device: nothing here
  reads a size on the host.  The combine ``.at[gtok].add`` is
  ``index_add_``, which adds in atomic order on the card.  Training
  differentiates it as ``jax.grad`` does: the router through the top-k
  weights and the aux loss's ``p_e``, the expert tensors through
  ``grouped_matmul``'s backward (kernel B6 on a card), the shared expert
  through torch's own ops; the histogram, like the reference's one-hot
  sum, carries no gradient.
* ``router_stats`` / ``split_aux``: the load-balance loss of a batch split
  over data-parallel members.  ``f_e`` and ``P_e`` are both batch means, so
  the mean of the members' losses is not the whole batch's; inside
  ``router_stats`` each ``route`` records its counts and ``P_e``, and
  ``split_aux`` forms from every member's records the member terms
  ``router_aux_loss · E · Σ_e f_e^batch · P_e^member`` / n, whose sum is
  the whole batch's loss and whose gradients are its gradients.

Expert-parallel dispatch (``moe_mlp_ep`` / ``_moe_ep_shardmapped``) is a
later slice (ROADMAP item 10c2b); the transformer's ``moe_impl="ep"``
raises until then.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.segment_agg import segment_agg
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense, dense_init, mlp, mlp_init, randn


def moe_init(gen, cfg: ModelConfig, device=None) -> Params:
    d, f = cfg.d_model, cfg.moe_d_ff
    e = cfg.moe_experts_padded  # padded experts never routed to (dead rows)
    p = {
        "router": dense_init(gen, d, cfg.moe_num_experts, scale=0.02, device=device),
        "w_gate": randn(gen, (e, d, f), device, d ** -0.5),
        "w_up": randn(gen, (e, d, f), device, d ** -0.5),
        "w_down": randn(gen, (e, f, d), device, f ** -0.5),
    }
    if cfg.moe_shared_d_ff:
        p["shared"] = mlp_init(gen, d, cfg.moe_shared_d_ff, "swiglu", device=device)
        p["shared_gate"] = dense_init(gen, d, 1, scale=0.02, device=device)
    return p


_STATS: list = []  # the open router_stats records, innermost last


@contextlib.contextmanager
def router_stats():
    """Inside, every ``route`` call appends ``(histogram, p_e)`` (its
    (E_pad,) token counts and its real experts' mean probabilities, with
    their graph) to the yielded list, in call order (layer order)."""
    records: list = []
    _STATS.append(records)
    try:
        yield records
    finally:
        _STATS.pop()


def split_aux(cfg: ModelConfig, members: list) -> list:
    """The load-balance loss of a batch split in equal parts over members,
    as one term a member: ``members`` holds each member's ``router_stats``
    records (same layers, same order).  A member's term is
    ``router_aux_loss · E · Σ_layers Σ_e f_e · P_e^member / n``, with
    ``f_e`` the whole batch's routed share (the members' counts summed; no
    gradient) and ``P_e^member`` on that member's device, so the terms sum
    to the whole batch's aux and each carries its member's share of the
    router's gradient."""
    e, n = cfg.moe_num_experts, len(members)
    home = members[0][0][0].device
    terms = [None] * n
    for layer in zip(*members):
        counts = layer[0][0].to(home)
        for hist, _ in layer[1:]:
            counts = counts + hist.to(home)
        f_e = counts[:e] / torch.clamp(torch.sum(counts), min=1.0)
        for i, (_, p_e) in enumerate(layer):
            t = torch.sum(f_e.to(p_e.device) * p_e)
            terms[i] = t if terms[i] is None else terms[i] + t
    scale = cfg.router_aux_loss * e / n
    return [None if t is None else t * scale for t in terms]


class RouterOut(NamedTuple):
    weights: torch.Tensor    # (T, k) combine weights (softmax over chosen)
    experts: torch.Tensor    # (T, k) int32 expert ids
    aux_loss: torch.Tensor   # () load-balance loss
    histogram: torch.Tensor  # (E_pad,) tokens routed per expert (GROUP BY COUNT)


def route(p: Params, cfg: ModelConfig, x2d: torch.Tensor) -> RouterOut:
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    ep = cfg.moe_experts_padded
    logits = dense(p["router"], x2d).float()  # (T, E) real experts
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)     # ids ∈ [0, E) ⊂ [0, E_pad)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    ids = ids.to(torch.int32)
    # GROUP BY expert COUNT, onehot strategy: the segment kernel on a card
    flat = ids.reshape(-1)
    hist = segment_agg(flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device),
                       num_groups=ep, kind="count", strategy="onehot", morsel_size=1)
    # Switch-style aux loss: E * Σ_e f_e · P_e (real experts only)
    f_e = hist[:e] / torch.clamp(torch.sum(hist), min=1.0)
    p_e = torch.mean(probs, dim=0)
    aux = cfg.router_aux_loss * e * torch.sum(f_e * p_e)
    if _STATS:
        _STATS[-1].append((hist, p_e))
    return RouterOut(w.to(x2d.dtype), ids, aux, hist)


def moe_mlp_dense(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """(B, S, D) → ((B, S, D), aux); experts computed with grouped matmuls
    over the expert-sorted rows (kernel B3 on a card)."""
    b, s, d = x.shape
    k = cfg.moe_top_k
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    r = route(p, cfg, x2)

    flat_e = r.experts.reshape(-1)                            # (T*k,)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_w = r.weights.reshape(-1)

    order = torch.argsort(flat_e, stable=True)                # radix partition
    gtok = flat_tok[order]
    gw = flat_w[order]
    gx = x2.index_select(0, gtok)                             # (T*k, D) grouped

    group_sizes = r.histogram.to(torch.int32)                 # (E_pad,), on the device

    def rdot(lhs, rhs):
        return grouped_matmul(lhs.float(), rhs.float(), group_sizes).to(x.dtype)

    h = F.silu(rdot(gx, p["w_gate"])) * rdot(gx, p["w_up"])  # (T*k, F)
    yo = rdot(h, p["w_down"])                                 # (T*k, D)

    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, gtok, yo * gw[:, None])
    if "shared" in p:
        sg = torch.sigmoid(dense(p["shared_gate"], x2).float()).to(x.dtype)
        out = out + sg * mlp(p["shared"], x2, "swiglu")
    return out.reshape(b, s, d), r.aux_loss
