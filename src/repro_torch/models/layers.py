"""Shared layers: norms, embeddings (incl. the paper-powered
TicketedEmbedding), MLPs, RoPE.

Port of ``repro.models.layers``.  Parameters are plain nested dicts of
tensors (the reference's pytrees, key for key); initializers draw from an
explicit ``torch.Generator`` on the generator's device and move the draw
to ``device``.  Compute runs in ``cfg.dtype`` (bf16 by default) with fp32
norms/softmax accumulations, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Params = dict


def randn(gen: torch.Generator, shape, device, std: float = 1.0) -> torch.Tensor:
    """A float32 standard-normal draw of ``shape`` from ``gen`` (made on the
    generator's device), times ``std``, on ``device``; on a ``meta``
    device only the shape (``launch/specs.py`` ``abstract_params``), with
    nothing drawn."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def layernorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def norm_init(kind: str, d: int, device=None) -> Params:
    return rmsnorm_init(d, device) if kind == "rmsnorm" else layernorm_init(d, device)


def apply_norm(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

def dense_init(gen, d_in: int, d_out: int, bias: bool = False, scale: float | None = None,
               device=None) -> Params:
    std = scale if scale is not None else d_in ** -0.5
    p = {"w": randn(gen, (d_in, d_out), device, std)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "w_q8" in p:
        # weight-only int8 (serving): per-out-channel scale, dequantized in
        # the compute dtype before the product, as the reference writes it
        w = p["w_q8"].to(x.dtype) * p["w_scale"].to(x.dtype)
    else:
        w = p["w"].to(x.dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def quantize_dense_params(params: Params) -> Params:
    """Weight-only int8 transform: every 2-D dense kernel {"w": (in,out)}
    becomes {"w_q8": int8, "w_scale": (1,out) f32}; stacked kernels
    (…, in, out) keep their leading (L, …) dims.  On a tree of ``meta``
    tensors (``launch/specs.py`` ``abstract_params``) it maps shapes and
    dtypes only: the dry run's ``twobuf_q8w`` variant
    (``launch/dryrun.py``), as the reference maps ``ShapeDtypeStruct``
    trees for its own."""

    def walk(node):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) >= 2:
                w = node["w"].float()
                rest = {k: v for k, v in node.items() if k != "w"}
                scale = torch.amax(torch.abs(w), dim=-2, keepdim=True) / 127.0 + 1e-8
                q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
                return {"w_q8": q, "w_scale": scale, **{k: walk(v) for k, v in rest.items()}}
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# embeddings — including the paper's technique as a first-class feature
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab: int, d: int, device=None) -> Params:
    return {"table": randn(gen, (vocab, d), device, d ** -0.5)}


def embed(p: Params, ids: torch.Tensor, dtype) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-take,
    # without a cast of the whole table each call
    table = p["table"]
    flat = table.index_select(0, ids.reshape(-1).long())
    return flat.reshape(*ids.shape, table.shape[1]).to(dtype)


def _ticket_ids(ids: torch.Tensor, max_unique: int, capacity: int, ticket_fn):
    """Step 1 of the embedding gradient: the ids as uint32 bit patterns,
    padded with ``EMPTY_I32`` to a multiple of 1024 rows (the ticket
    kernel's tile), ticketed against a fresh table of ``capacity`` slots.
    Returns ``(tickets of the ids' rows, key_by_ticket, count)``."""
    from repro_torch.core.hashing import EMPTY_I32

    keys = ids.reshape(-1).to(torch.int32)
    n = keys.shape[0]
    pad = -n % 1024
    if pad:
        keys = torch.cat([keys, torch.full((pad,), EMPTY_I32, dtype=torch.int32,
                                           device=keys.device)])
    tickets, _, _, key_by_ticket, count = ticket_fn(keys, capacity=capacity,
                                                    max_groups=max_unique)
    return tickets[:n], key_by_ticket, count


def _scatter_rows(seg: torch.Tensor, key_by_ticket: torch.Tensor, count: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Step 3: ONE ``index_add_`` of the live ticket rows (``arange(G) <
    count``) at their keys into a zero ``(vocab, d)`` float32 table; dead
    rows go to a row past the table, which is dropped (the reference's
    ``mode="drop"``).  No host read: ``count`` stays on the device."""
    g = seg.shape[0]
    live = torch.arange(g, device=seg.device) < count
    idx = torch.where(live, key_by_ticket, vocab).long()
    dtable = torch.zeros((vocab + 1, seg.shape[1]), dtype=torch.float32, device=seg.device)
    return dtable.index_add_(0, idx, seg)[:vocab]


def ticketed_embed_grad(ids: torch.Tensor, g: torch.Tensor, vocab: int, max_unique: int,
                        capacity: int) -> torch.Tensor:
    """The gradient of the ``(vocab, d)`` table under ``ticketed_embed``:
    GROUP BY token_id SUM(cotangent), the paper's pipeline (reference
    ``layers.py:142-165``).  The ids are ticketed by the ticket kernel
    (:func:`~repro_torch.kernels.ticket_hash.ticket_hash`), the float32
    cotangent rows are summed in ticket space by kernel B5
    (:func:`~repro_torch.kernels.segment_rows.segment_rows`), rows whose
    ticket is -1 or ``>= max_unique`` dropped, and one ``index_add_`` lands
    the sums in the table.  CUDA tensors launch the two kernels; CPU
    tensors take their plain versions.  Never ``core.ticketing
    .get_or_insert``: on CUDA tensors it runs claim rounds from the host."""
    from repro_torch.kernels.segment_rows import segment_rows
    from repro_torch.kernels.ticket_hash import ticket_hash

    tickets, key_by_ticket, count = _ticket_ids(ids, max_unique, capacity, ticket_hash)
    seg = segment_rows(g.reshape(-1, g.shape[-1]).float(), tickets, max_unique)
    return _scatter_rows(seg, key_by_ticket, count, vocab)


def ticketed_embed_grad_plain(ids: torch.Tensor, g: torch.Tensor, vocab: int,
                              max_unique: int, capacity: int) -> torch.Tensor:
    """:func:`ticketed_embed_grad` through the kernels' plain versions
    (``ticket_hash_plain``, ``segment_rows_plain``) on any device: the
    card's oracle.  Its tickets are numbered in row order, the kernel's are
    not, so the two agree as tables, not as ticket vectors."""
    from repro_torch.kernels.segment_rows import segment_rows_plain
    from repro_torch.kernels.ticket_hash import ticket_hash_plain

    tickets, key_by_ticket, count = _ticket_ids(ids, max_unique, capacity, ticket_hash_plain)
    seg = segment_rows_plain(g.reshape(-1, g.shape[-1]).float(), tickets, max_unique)
    return _scatter_rows(seg, key_by_ticket, count, vocab)


class _TicketedEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, max_unique, capacity):
        ctx.save_for_backward(ids)
        ctx.shape = (table.shape, table.dtype, max_unique, capacity)
        flat = table.index_select(0, ids.reshape(-1).long())
        return flat.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        (vocab, _), dtype, max_unique, capacity = ctx.shape
        dtable = ticketed_embed_grad(ids, g, vocab, max_unique, capacity)
        return dtable.to(dtype), None, None, None


def ticketed_embed(table: torch.Tensor, ids: torch.Tensor, max_unique: int, capacity: int):
    """Embedding gather whose BACKWARD runs the paper's pipeline (reference
    ``layers.py:120-165``): ticket the ids, segment-sum the cotangents in
    ticket space, one dense scatter into the table
    (:func:`ticketed_embed_grad`).  ``max_unique`` bounds the distinct ids
    of one call (rows past it get no gradient, as in the reference);
    ``capacity`` is the ticket table's slots, a power of two."""
    return _TicketedEmbed.apply(table, ids, max_unique, capacity)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, kind: str = "swiglu", device=None) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, d_ff, device=device),
            "w_up": dense_init(gen, d, d_ff, device=device),
            "w_down": dense_init(gen, d_ff, d, device=device),
        }
    return {"w_up": dense_init(gen, d, d_ff, device=device),
            "w_down": dense_init(gen, d_ff, d, device=device)}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def mlp(p: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        return dense(p["w_down"], F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    if kind == "geglu":
        return dense(p["w_down"], gelu_tanh(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    return dense(p["w_down"], gelu_tanh(dense(p["w_up"], x)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float = 1.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    interleaved pairs (``0::2`` with ``1::2``), as the reference does, not
    HF's rotate-half; the first ``rope_fraction`` of each head rotates."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]         # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked recurrences (rwkv.py, ssm.py)
# ---------------------------------------------------------------------------

def chunk_runs(s: int, chunk: int) -> list:
    """``(lo, hi, c)`` runs covering a sequence of ``s`` steps in chunks of
    ``c`` steps: ``[0, s − s % c)`` in chunks of ``min(chunk, s)``, then the
    ``s % c`` steps left as one shorter chunk, if any.  The reference's
    chunked paths refuse an ``s`` that is not a multiple of the chunk
    (ROADMAP §3 fault 14); the port runs the rest as a last chunk, seeded
    from the state the full chunks leave."""
    c = min(chunk, s)
    full = s - s % c
    return [(lo, hi, n) for lo, hi, n in ((0, full, c), (full, s, s - full)) if hi > lo]
