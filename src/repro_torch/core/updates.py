"""Partial-aggregate update and materialization (paper §3.2).

Ported so far: the neutrals (:func:`neutral`, :func:`init_acc`),
:func:`scatter_update` (the split route's merge of a chunk partial into the
carried accumulators, plain PyTorch as it is plain ``jnp`` in the
reference) and :func:`finalize`.  ``AggState`` and the other update
strategies (onehot, sort_segment, serialized) come with the scan route.
"""
from __future__ import annotations

import torch

_NEUTRAL = {
    "sum": 0.0,
    "count": 0.0,
    "min": float("inf"),
    "max": float("-inf"),
}


def neutral(kind: str, dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity of ``kind`` as a 0-d tensor."""
    return torch.tensor(_NEUTRAL[kind], dtype=dtype, device=device)


def init_acc(num_groups: int, kind: str, dtype=torch.float32,
             width: int | None = None, device=None) -> torch.Tensor:
    """A ``(num_groups,)`` (or ``(num_groups, width)``) accumulator filled
    with the kind's neutral."""
    shape = (num_groups,) if width is None else (num_groups, width)
    return torch.full(shape, _NEUTRAL[kind], dtype=dtype, device=device)


def _masked(tickets: torch.Tensor, values: torch.Tensor | None, kind: str,
            num_groups: int):
    """Redirect invalid rows to the parking slot ``num_groups`` and
    neutralize their values; ``count`` reads ones.  Invalid: ticket < 0,
    and ticket >= ``num_groups`` (the reference's scatter drops an
    out-of-range index; ``index_add_`` would raise)."""
    t = tickets.reshape(-1).to(torch.int64)
    if kind == "count":
        v = torch.ones(t.shape, dtype=torch.float32, device=t.device)
    elif values.dim() > tickets.dim():
        v = values.reshape(t.shape[0], -1)
    else:
        v = values.reshape(-1)
    ok = (t >= 0) & (t < num_groups)
    t = torch.where(ok, t, torch.full_like(t, num_groups))
    okv = ok[:, None] if v.dim() > 1 else ok
    v = torch.where(okv, v, torch.full_like(v, _NEUTRAL[kind]))
    return t, v


def scatter_update(acc: torch.Tensor, tickets: torch.Tensor,
                   values: torch.Tensor | None, kind: str = "sum") -> torch.Tensor:
    """Scatter-accumulate ``values`` into ``acc`` at ``tickets`` (rows with
    ticket < 0 or >= G ignored).  Returns a new tensor; ``acc`` is not
    modified.  Invalid rows land on one extra slot past the end, which is
    cut off."""
    if kind not in _NEUTRAL:
        raise ValueError(kind)
    g = acc.shape[0]
    t, v = _masked(tickets, values, kind, g)
    pad = torch.full((1, *acc.shape[1:]), _NEUTRAL[kind], dtype=acc.dtype,
                     device=acc.device)
    wide = torch.cat([acc, pad])
    v = v.to(acc.dtype)
    if kind in ("sum", "count"):
        wide.index_add_(0, t, v)
    else:
        idx = t[:, None].expand_as(v) if v.dim() > 1 else t
        wide.scatter_reduce_(0, idx, v, "amin" if kind == "min" else "amax")
    return wide[:g]


def finalize(kind: str, acc: torch.Tensor, count_acc: torch.Tensor | None = None):
    """Materialize final aggregate values: untouched min/max identities
    (±inf) become NaN, mean is sum / max(count, 1)."""
    if kind in ("min", "max"):
        return torch.where(torch.isinf(acc), torch.full_like(acc, float("nan")), acc)
    if kind == "mean":
        if count_acc is None:
            raise ValueError("mean needs its count accumulator")
        return acc / torch.clamp(count_acc, min=1.0)
    return acc
