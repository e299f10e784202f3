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

* ``moe_mlp_ep``: expert-parallel dispatch over the members of one
  ``model`` group of a mesh (the reference's ``moe_mlp_ep`` under
  ``shard_map``, ``moe.py:130-232``).  A single controller cannot call a
  collective from one member's function, so the function takes every
  member's parameters and tokens and runs the reference's stages for all of
  them: the sender (``route``, a stable argsort by expert, each row's place
  in its expert group by searchsorted, the capacity clamp, and the
  ``(n, E_local·cap, D)`` send buckets), ``parallel.sharding.all_to_all``,
  the local experts as batched products in ``x.dtype`` (``torch.bmm``, as
  the reference's einsums), the return ``all_to_all`` and the combine
  (``index_add_`` of the kept rows times their weights, plus the shared
  expert).  The sender is the paper's partitioned GROUP BY by expert
  owner; ``transformer._moe_ep_shardmapped`` places it on a mesh.
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
from repro_torch.parallel import sharding


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
    # the k largest, the lower expert first among equal probabilities, as
    # jax.lax.top_k orders them (torch.topk leaves ties in no set order; a
    # zero row, as token slicing pads with, ties every expert)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]             # ids ∈ [0, E) ⊂ [0, E_pad)
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


# ---------------------------------------------------------------------------
# expert-parallel dispatch over a model group: partition → all_to_all →
# experts → all_to_all → combine


class _Sent(NamedTuple):
    buckets: torch.Tensor   # (n, E_local·cap, D) rows for each owner
    dest: torch.Tensor      # (T·k,) row of the flat buckets, n·E_local·cap if dropped
    keep: torch.Tensor      # (T·k,) bool: within its expert's capacity
    tok: torch.Tensor       # (T·k,) the token of each (token, slot) row
    weights: torch.Tensor   # (T·k,) combine weights
    aux: torch.Tensor       # () this member's load-balance loss


def _ep_send(p: Params, cfg: ModelConfig, x2: torch.Tensor, n: int, cap: int) -> _Sent:
    """The sender (``moe.py:154-173``): route, stable argsort by expert, the
    position of each row in its expert group, the capacity clamp (rows past
    ``cap`` keep only their other k-1 routes) and the send buckets."""
    t, d = x2.shape
    k, e_local = cfg.moe_top_k, cfg.moe_experts_padded // n
    r = route(p, cfg, x2)
    flat_e = r.experts.reshape(-1).long()
    flat_tok = torch.arange(t, device=x2.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_sorted = torch.arange(t * k, device=x2.device) - torch.searchsorted(sorted_e, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = (flat_e % e_local) * cap + pos  # the row within the owner's bucket
    rows = n * e_local * cap
    dest = torch.where(keep, (flat_e // e_local) * (e_local * cap) + slot,
                       torch.full_like(slot, rows))
    send = torch.zeros((rows + 1, d), dtype=x2.dtype, device=x2.device)
    send = send.index_copy(0, dest, x2.index_select(0, flat_tok))[:-1]  # the sentinel row dropped
    return _Sent(send.reshape(n, e_local * cap, d), dest, keep, flat_tok,
                 r.weights.reshape(-1), r.aux_loss)


def _exchange(buckets: list, members, quantize: bool) -> list:
    """``sharding.all_to_all`` of each member's ``(n, rows, D)`` buckets.
    Under ``quantize`` (``moe.py:176-188``, ``:209-219``) each destination's
    bucket travels as int8 beside its float32 scale ``max|·|/127 + 1e-8``;
    the int8 cast carries no gradient, the scale does, as ``jax.grad``
    through ``round`` and ``astype(int8)``."""
    if not quantize:
        return sharding.all_to_all(buckets, members)
    qs, scales = [], []
    for b in buckets:
        f = b.float()
        s = torch.amax(torch.abs(f), dim=(1, 2), keepdim=True) / 127.0 + 1e-8
        qs.append(torch.clamp(torch.round(f / s), -127, 127).to(torch.int8))
        scales.append(s)
    got = zip(sharding.all_to_all(qs, members), sharding.all_to_all(scales, members), buckets)
    return [(q.float() * s).to(b.dtype) for q, s, b in got]


def _ep_experts(p: Params, recv: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """The owner's experts over what it received, sender-major ``(n,
    E_local·cap, D)``: SwiGLU per local expert over ``n·cap`` rows in the
    rows' dtype; returns the results in the same layout."""
    e_local, d = p["w_gate"].shape[0], recv.shape[-1]
    xe = recv.reshape(n, e_local, cap, d).transpose(0, 1).reshape(e_local, n * cap, d)
    wg, wu, wd = (p[w].to(recv.dtype) for w in ("w_gate", "w_up", "w_down"))
    ye = torch.bmm(F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu), wd)
    return ye.reshape(e_local, n, cap, d).transpose(0, 1).reshape(n, e_local * cap, d)


def _ep_combine(p: Params, sent: _Sent, ret: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Each kept (token, slot) row reads its expert's output back, weighted,
    into its token (``moe.py:222-231``), plus the shared expert."""
    ret = ret.reshape(-1, x2.shape[1])
    got = ret.index_select(0, torch.clamp(sent.dest, max=ret.shape[0] - 1))
    got = torch.where(sent.keep[:, None], got, torch.zeros((), dtype=got.dtype, device=got.device))
    out = torch.zeros_like(x2).index_add(0, sent.tok, got * sent.weights[:, None])
    if "shared" in p:
        sg = torch.sigmoid(dense(p["shared_gate"], x2).float()).to(x2.dtype)
        out = out + sg * mlp(p["shared"], x2, "swiglu")
    return out


def moe_mlp_ep(p_locals: list, cfg: ModelConfig, xs: list, *, members, capacity_per_expert: int,
               quantize_dispatch: bool = False) -> list:
    """Expert parallelism over the ``n`` members of one ``model`` group:
    member r holds ``p_locals[r]`` (the router and shared expert whole, the
    expert stacks' rows ``[r·E_local, (r+1)·E_local)``) and its tokens
    ``xs[r]`` (B, S, D), both on ``members[r].device``.  Returns each
    member's ``(out (B, S, D), aux)``, as the reference returns them from
    inside ``shard_map``: the sender of every member, one exchange, the
    owners' experts, the return exchange, then every member's combine.
    ``capacity_per_expert`` rows of each sender reach an expert; the rest
    of its rows are dropped (their other routes stay).  Differentiable:
    autograd runs through the exchanges, which are ``.to()`` and
    ``stack``."""
    n, cap = len(members), capacity_per_expert
    if len(p_locals) != n or len(xs) != n:
        raise ValueError(f"{len(p_locals)} parameter sets and {len(xs)} inputs for {n} members")
    if cfg.moe_experts_padded % n:
        raise ValueError(f"{cfg.moe_experts_padded} experts do not split over {n} members")
    x2s = [x.reshape(-1, x.shape[-1]) for x in xs]
    sent = [_ep_send(p, cfg, x2, n, cap) for p, x2 in zip(p_locals, x2s)]
    recv = _exchange([s.buckets for s in sent], members, quantize_dispatch)
    back = [_ep_experts(p, r, n, cap) for p, r in zip(p_locals, recv)]
    ret = _exchange(back, members, quantize_dispatch)
    return [(_ep_combine(p, s, r, x2).reshape(x.shape), s.aux)
            for p, s, r, x2, x in zip(p_locals, sent, ret, x2s, xs)]
