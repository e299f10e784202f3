"""Partial-aggregate update strategies (paper §3.2).

Port of ``repro.core.updates``.  After ticketing, every row carries a dense
ticket and aggregation reduces to updating ``acc[ticket]`` with the row's
value.  The four strategies of the reference:

  * :func:`scatter_update` — ``index_add_`` / ``scatter_reduce_``, the
    counterpart of XLA's scatter (the atomic analogue);
  * :func:`onehot_update` — ``one_hot(tickets)ᵀ @ values`` (min / max as a
    masked dense reduce), in row blocks so that one block × G stays within
    :data:`ONEHOT_BLOCK_BYTES`: the reference's single (K × G) matrix does
    not fit at G = 2^24;
  * :func:`sort_segment_update` — ``argsort`` by ticket, then a segment
    reduce over the sorted runs (``torch.segment_reduce``);
  * :func:`serialized_update` — one row at a time, in row order: a plain
    row loop on CPU tensors, a one-thread kernel (``csrc/segment_agg.cu``)
    on CUDA tensors.  Measurement only (the fine-grained-locking stand-in).

Every strategy has the signature ``update(acc, tickets, values, kind=...)
-> acc`` with ``acc`` a ``(G,)`` (or, for scatter, ``(G, V)``) float
accumulator; rows whose ticket is < 0 or >= G are ignored.  Unlike the
reference's pure functions, **every strategy folds into ``acc`` in place
and returns it**: the port's accumulators are carried state, and a copy of
a G-wide vector per call is what the scan route must not pay at G = 2^24.
A caller that needs the old value clones first.  ``kind`` ∈ {sum, count,
min, max}; mean is (sum, count) composed by the caller.  ``count`` reads
ones.

:class:`AggState` bundles every accumulator a GROUP BY query carries, one
per ``(column, kind)`` pair.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import torch

_NEUTRAL = {
    "sum": 0.0,
    "count": 0.0,
    "min": float("inf"),
    "max": float("-inf"),
}

# The most bytes one row block of onehot_update may take: K rows × G
# groups of one bool mask byte and one float32 (4 B) operand.
ONEHOT_BLOCK_BYTES = 256 << 20


def neutral(kind: str, dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity of ``kind`` as a 0-d tensor."""
    return torch.tensor(_NEUTRAL[kind], dtype=dtype, device=device)


def init_acc(num_groups: int, kind: str, dtype=torch.float32,
             width: int | None = None, device=None) -> torch.Tensor:
    """A ``(num_groups,)`` (or ``(num_groups, width)``) accumulator filled
    with the kind's neutral."""
    shape = (num_groups,) if width is None else (num_groups, width)
    return torch.full(shape, _NEUTRAL[kind], dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class AggState:
    """Per-``(column, kind)`` accumulators of one GROUP BY query.

    Attributes:
      specs: tuple of ``(column | None, kind)`` pairs, deduplicated, in
        declaration order (``mean`` callers register sum + count).
      accs:  tuple of ``(num_groups,)`` float32 accumulators, aligned with
        ``specs``.
    """

    specs: tuple
    accs: tuple

    @property
    def num_groups(self) -> int:
        return self.accs[0].shape[0]

    def get(self, column, kind: str) -> torch.Tensor:
        """Accumulator of one (column, kind) pair."""
        return self.accs[self.specs.index((column, kind))]


def init_agg_state(specs: Sequence[tuple], num_groups: int, dtype=torch.float32,
                   device=None) -> AggState:
    """Neutral accumulators for ``specs`` = [(column | None, kind), ...]."""
    specs = tuple(dict.fromkeys((col, kind) for col, kind in specs))
    if not specs:
        raise ValueError("at least one aggregate spec required")
    return AggState(specs, tuple(init_acc(num_groups, k, dtype, device=device)
                                 for _, k in specs))


def grow_agg_state(state: AggState, num_groups: int) -> AggState:
    """Widen every accumulator to ``num_groups`` slots, padded with the
    kind's neutral (tickets are stable under growth).  Returns a new
    state; ``state`` is not modified."""
    if num_groups < state.num_groups:
        raise ValueError(f"grow_agg_state cannot shrink: {num_groups} < {state.num_groups}")
    if num_groups == state.num_groups:
        return state
    accs = []
    for (_, kind), acc in zip(state.specs, state.accs):
        pad = torch.full((num_groups - acc.shape[0], *acc.shape[1:]), _NEUTRAL[kind],
                         dtype=acc.dtype, device=acc.device)
        accs.append(torch.cat([acc, pad]))
    return AggState(state.specs, tuple(accs))


def update_agg_state(state: AggState, tickets: torch.Tensor,
                     values_by_column: Mapping[str, torch.Tensor],
                     update_fn: Callable) -> AggState:
    """Fold one batch of ticketed rows (a morsel, or a whole chunk's
    ticket vector) into every accumulator, in place."""
    accs = []
    for (col, kind), acc in zip(state.specs, state.accs):
        if col is None:
            vals = torch.ones(tickets.shape, dtype=torch.float32, device=tickets.device)
        else:
            vals = values_by_column[col]
        accs.append(update_fn(acc, tickets, vals, kind=kind))
    return AggState(state.specs, tuple(accs))


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


def _check_kind(kind: str) -> None:
    if kind not in _NEUTRAL:
        raise ValueError(f"unknown kind {kind!r}; available: {tuple(_NEUTRAL)}")


def scatter_update(acc: torch.Tensor, tickets: torch.Tensor,
                   values: torch.Tensor | None, kind: str = "sum") -> torch.Tensor:
    """Scatter-accumulate ``values`` into ``acc`` at ``tickets``, in place.
    Invalid rows fold their neutral into slot 0, which leaves it as it was
    (a parking slot past the end would cost a copy of ``acc``)."""
    _check_kind(kind)
    g = acc.shape[0]
    if g == 0:
        return acc
    t, v = _masked(tickets, values, kind, g)
    t = torch.where(t == g, torch.zeros_like(t), t)
    v = v.to(acc.dtype)
    if kind in ("sum", "count"):
        acc.index_add_(0, t, v)
    else:
        idx = t[:, None].expand_as(v) if v.dim() > 1 else t
        acc.scatter_reduce_(0, idx, v, "amin" if kind == "min" else "amax")
    return acc


def _combine_(acc: torch.Tensor, part: torch.Tensor, kind: str) -> torch.Tensor:
    """acc (+)= part in place: add for sum / count, elementwise min / max."""
    if kind in ("sum", "count"):
        return acc.add_(part)
    fn = torch.minimum if kind == "min" else torch.maximum
    return fn(acc, part, out=acc)


def onehot_update(acc: torch.Tensor, tickets: torch.Tensor,
                  values: torch.Tensor | None, kind: str = "sum") -> torch.Tensor:
    """Contention → dense work, in place: per row block, ``onehotᵀ @ v``
    for sum / count and a masked dense reduce for min / max.  A block
    holds at most ``ONEHOT_BLOCK_BYTES / (5 · G)`` rows (one mask byte and
    one float32 operand per row and group)."""
    _check_kind(kind)
    g = acc.shape[0]
    if g == 0:
        return acc
    t, v = _masked(tickets, values, kind, g)
    v = v.to(acc.dtype)
    cols = torch.arange(g, device=acc.device)
    rows = max(1, ONEHOT_BLOCK_BYTES // (5 * g))
    for lo in range(0, t.shape[0], rows):
        sel = t[lo:lo + rows, None] == cols[None, :]      # parked rows match none
        vb = v[lo:lo + rows]
        if kind in ("sum", "count"):
            acc.add_(sel.to(acc.dtype).T @ vb)
        else:
            vv = vb if vb.dim() == 1 else vb[:, 0]
            dense = torch.where(sel, vv[:, None], torch.full_like(vv[:1, None], _NEUTRAL[kind]))
            red = dense.amin(dim=0) if kind == "min" else dense.amax(dim=0)
            _combine_(acc, red, kind)
    return acc


def sort_segment_update(acc: torch.Tensor, tickets: torch.Tensor,
                        values: torch.Tensor | None, kind: str = "sum") -> torch.Tensor:
    """Sort rows by ticket, then a contention-free segment reduction over
    the sorted runs (``torch.segment_reduce`` with one segment per ticket
    and one for the parked rows, as the reference's ``num_segments = G +
    1``), folded into ``acc`` in place."""
    _check_kind(kind)
    g = acc.shape[0]
    if g == 0:
        return acc
    t, v = _masked(tickets, values, kind, g)
    order = torch.argsort(t, stable=True)
    ts, vs = t[order], v[order].to(acc.dtype)
    offsets = torch.searchsorted(ts, torch.arange(g + 2, device=ts.device))
    reduce = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}[kind]
    seg = torch.segment_reduce(vs, reduce, offsets=offsets, axis=0,
                               initial=_NEUTRAL[kind])
    return _combine_(acc, seg[:g], kind)


def serialized_update(acc: torch.Tensor, tickets: torch.Tensor,
                      values: torch.Tensor | None, kind: str = "sum") -> torch.Tensor:
    """Strictly sequential row-at-a-time updates, in row order, in place:
    exists to measure what full serialization costs (paper Fig. 5's
    'Locking' series).  CUDA tensors launch the one-thread kernel of
    ``csrc/segment_agg.cu`` (``kernels.segment_agg.serialized_agg``); CPU
    tensors run its plain row loop.  Never a Python loop on the card."""
    _check_kind(kind)
    from repro_torch.kernels import segment_agg as sa

    t, v = _masked(tickets, values, kind, acc.shape[0])
    return sa.serialized_agg(acc, t.to(torch.int32), v, kind=kind)


UPDATE_FNS: dict[str, Callable] = {
    "scatter": scatter_update,
    "onehot": onehot_update,
    "sort_segment": sort_segment_update,
    "serialized": serialized_update,
}


def get_update_fn(name: str) -> Callable:
    try:
        return UPDATE_FNS[name]
    except KeyError:
        raise ValueError(
            f"unknown update strategy {name!r}; available: {sorted(UPDATE_FNS)}"
        ) from None


def finalize(kind: str, acc: torch.Tensor, count_acc: torch.Tensor | None = None):
    """Materialize final aggregate values as a new tensor (never a view of
    the carried accumulator, which later updates change in place):
    untouched min/max identities (±inf) become NaN, mean is sum / max(count,
    1)."""
    if kind in ("min", "max"):
        return torch.where(torch.isinf(acc), torch.full_like(acc, float("nan")), acc)
    if kind == "mean":
        if count_acc is None:
            raise ValueError("mean needs its count accumulator")
        return acc / torch.clamp(count_acc, min=1.0)
    return acc.clone()
