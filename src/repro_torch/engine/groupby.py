"""The GROUP BY operator of the scan route, its pause protocol, and the
uniform result layout.

Port of ``repro.engine.groupby``.  :class:`GroupByOperator` consumes a
stream of chunks into one carried ticket table and its accumulators
(``AggState``) and materializes at ``finalize``; it is the operator behind
``strategy="concurrent"`` with ``ExecutionPolicy.kernel`` ∈ {None, "off",
"scan_body"} (``engine/executors._ScanExecutor``).

How a chunk is consumed (``pipeline="scan"``).  The reference compiles ONE
``jax.lax.scan`` over the chunk's morsels: per morsel the §4.4 room check,
GET_OR_INSERT and the update of every accumulator.  The port splits the
morsel loop into two stages, each dispatched once per chunk without a host
sync:

1. the ticket stage, ``kernels.fused_groupby.scan_ticket``: the fused
   kernel's morsel dispatch with tiled, cached GET_OR_INSERT
   (``scan_ticket_kernel`` in ``csrc/fused_groupby.cu``) on CUDA tensors, :func:`make_pause_scan_body` (the reference's own
   per-morsel body) on CPU tensors.  It writes every row's ticket for the
   morsels it commits, -1 for the rest, clears those morsels' ``todo``
   flags and reports the §4.4 info vector;
2. the update stage: the update strategy (``core.updates``, or the segment
   kernel with ``kernel="scan_body"``) over the chunk's ticket vector, once
   per accumulator plane; rows at -1 are parked.

``poll`` reads the info vector once.  While a morsel is still todo it
grows exactly as the reference does (``_grow``: the bound ×4 or count + M,
capacity ×2 by ``kernels.table_ops.migrate``, the card's migration kernel
on CUDA tensors and ``resize.migrate`` on the CPU, a forced doubling when
a pause survives a replay at the same first-todo morsel), relaunches on
the todo mask and updates the newly committed rows only.  Unchecked
streams never sync.

On the card a morsel of more than ``fused_groupby.MAX_MORSEL_ROWS`` rows is
split into sub-morsels of at most that many rows, each with its own room
check: pause points the reference lacks, which change no result.  The CPU
path keeps the true morsels and matches the JAX operator ticket for ticket.

``pipeline="host"`` keeps the reference's per-morsel Python loop (one
GET_OR_INSERT, one blocking resize check and one update per morsel) for
A/B tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32, table_capacity
from repro_torch.engine.columns import Table, chunk_key_column
from repro_torch.engine.morsels import DEFAULT_MORSEL_ROWS, morselize_chunk
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


class GroupByOverflowError(RuntimeError):
    """The stream held more distinct keys than ``max_groups``."""


@dataclass(frozen=True)
class AggSpec:
    kind: str        # sum | count | min | max | mean
    column: str | None = None  # None for count

    @property
    def name(self) -> str:
        return f"{self.kind}({self.column or '*'})"


def resolve_device(device: str | None) -> torch.device:
    """THE device rule: ``None`` → ``"cuda"``; a CUDA device that is not
    there raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ExecutionPolicy.device={device!r} runs on CUDA and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev


def build_result_table(aggs, get_acc, key_by_ticket, count, max_groups) -> Table:
    """THE uniform GROUP BY result layout: keys in ticket order (int64
    holding the unsigned key), one materialized column per aggregate (mean
    composed from sum/count, min/max identities → NaN), and the broadcast
    int32 group count."""
    kbt = key_by_ticket.reshape(-1)
    n = kbt.shape[0]
    if n < max_groups:
        kbt = torch.cat([kbt, kbt.new_full((max_groups - n,), EMPTY_I32)])
    out = {"key": kbt[:max_groups].to(torch.int64) & 0xFFFFFFFF}
    for a in aggs:
        if a.kind == "mean":
            out[a.name] = up.finalize(
                "mean", get_acc(a.column, "sum"), get_acc(a.column, "count")
            )
        else:
            out[a.name] = up.finalize(a.kind, get_acc(a.column, a.kind))
    count = torch.as_tensor(count, dtype=torch.int32, device=kbt.device).reshape(())
    out["__num_groups__"] = count.expand(max_groups).clone()
    return Table(out)


def expand_agg_specs(aggs: Sequence[AggSpec]) -> tuple:
    """Deduplicated ``(column, kind)`` accumulator specs for a query's aggs
    (``mean`` decomposes into sum+count, composed back at materialization)."""
    specs = []
    for a in aggs:
        kinds = ("sum", "count") if a.kind == "mean" else (a.kind,)
        for k in kinds:
            specs.append((a.column, k))
    return tuple(dict.fromkeys(specs))


# ---------------------------------------------------------------------------
# the per-morsel body: §4.4 room check → ticket → commit


def accumulate_scan_events(events, mkeys, probe_len, commit, pause_sat, halt_now):
    """Fold one morsel's event counts into the int32 event vector (layout:
    ``obs.metrics`` EVT_* slots + probe-length histogram buckets); returns a
    new vector.  Committed-only semantics: rows, masked rows and probe
    steps accrue only when ``commit`` is true; ``pause_sat`` / ``halt_now``
    count the saturation and the pause themselves.  The flags are bools or
    0-d tensors."""
    dev = events.device
    c = torch.as_tensor(commit, device=dev).to(torch.int64)
    valid = mkeys.reshape(-1) != EMPTY_I32
    plen = probe_len.reshape(-1).to(torch.int64)
    n_valid = valid.sum()
    add = torch.zeros(obs_metrics.EVENT_VEC_LEN + 1, dtype=torch.int64, device=dev)
    add[obs_metrics.EVT_MORSELS] = c
    add[obs_metrics.EVT_ROWS] = c * n_valid
    add[obs_metrics.EVT_ROWS_MASKED] = c * (valid.shape[0] - n_valid)
    add[obs_metrics.EVT_PROBE_STEPS] = c * plen.sum()
    add[obs_metrics.EVT_PROBE_SATURATIONS] = torch.as_tensor(pause_sat, device=dev).to(torch.int64)
    add[obs_metrics.EVT_PAUSES] = torch.as_tensor(halt_now, device=dev).to(torch.int64)
    # probe-length histogram of committed valid lanes; the rest park on the
    # extra slot past the end
    edges = torch.tensor(obs_metrics.PROBE_HIST_EDGES, dtype=torch.int64, device=dev)
    bucket = torch.searchsorted(edges, plen, right=True)
    idx = torch.where(valid & (c != 0), obs_metrics.NUM_EVENTS + bucket,
                      torch.full_like(bucket, obs_metrics.EVENT_VEC_LEN))
    add.index_add_(0, idx, torch.ones_like(idx))
    return events + add[:obs_metrics.EVENT_VEC_LEN].to(events.dtype)


def _ticket_morsel(table, keys, live: bool):
    """GET_OR_INSERT of one morsel's keys when ``live``, else a no-op (all
    rows EMPTY: tickets -1, probe lengths 0, the table as it was).  Returns
    ``(tickets, table, probe_len, mkeys)``."""
    if not live:
        mkeys = torch.full_like(keys, EMPTY_I32)
        return (torch.full_like(keys, -1), table,
                torch.zeros_like(keys), mkeys)
    tickets, table, probe_len = tk.get_or_insert(table, keys, count_probes=True)
    return tickets, table, probe_len, keys


def make_pause_scan_body(start, threshold, bound_slack, apply_update,
                         count_events=False):
    """THE checked pause/commit morsel body (reference ``:144``), eager:
    ``body(carry, (idx, keys, vals)) → (carry, halt_now)`` with carry
    ``(table, state, halted)``, or ``(table, state, halted, events)`` with
    ``count_events``.

    A pausing morsel commits nothing: the pre-morsel room check (count >
    ``threshold``, or > ``bound_slack`` when that is not None) halts
    BEFORE ticketing, and a morsel that saturates the probe table has its
    update dropped (its inserts stay: replay takes the lookup path).
    ``apply_update(state, tickets, vals)`` folds one committed morsel into
    the caller's state; it is called only for a morsel that commits (the
    reference computes it for every morsel and selects by the commit
    flag).  Morsels with ``idx < start`` and every morsel after a halt are
    no-ops."""

    def body(carry, xs):
        if count_events:
            table, state, halted, events = carry
        else:
            table, state, halted = carry
        idx, keys, vals = xs
        count = int(table.count)
        wants = idx >= start
        needs_room = count > threshold or (bound_slack is not None and count > bound_slack)
        halt_grow = wants and not halted and needs_room
        halted = halted or halt_grow
        live = wants and not halted
        tickets, table, probe_len, mkeys = _ticket_morsel(table, keys, live)
        sat = live and bool(((tickets < 0) & (mkeys != EMPTY_I32)).any())
        commit = live and not sat
        if commit:
            state = apply_update(state, tickets, vals)
        halt_now = halt_grow or sat
        halted = halted or halt_now
        if count_events:
            events = accumulate_scan_events(events, mkeys, probe_len, commit, sat, halt_now)
            return (table, state, halted, events), halt_now
        return (table, state, halted), halt_now

    return body


def make_unchecked_scan_body(start, apply_update, count_events=False):
    """The unchecked morsel body (the paper's perfect-estimate regime; the
    reference's inline body of ``_consume_scan(checked=False)``): no room
    check and no pause; every wanted morsel commits, rows that fail to
    ticket stay at -1 and are parked by the update, and a saturated morsel
    counts one saturation event.  Same carry as
    :func:`make_pause_scan_body`; ``halt_now`` is always False."""

    def body(carry, xs):
        if count_events:
            table, state, halted, events = carry
        else:
            table, state, halted = carry
        idx, keys, vals = xs
        wants = idx >= start
        tickets, table, probe_len, mkeys = _ticket_morsel(table, keys, wants)
        if wants:
            state = apply_update(state, tickets, vals)
        if count_events:
            sat = wants and bool(((tickets < 0) & (mkeys != EMPTY_I32)).any())
            events = accumulate_scan_events(events, mkeys, probe_len, wants, sat, False)
            return (table, state, halted, events), False
        return (table, state, halted), False

    return body


# ---------------------------------------------------------------------------
# the operator


@dataclass
class GroupByOperator:
    """The scan route's GROUP BY operator (see the module docstring).  The
    fields are the reference's, plus ``device`` (``None`` → ``"cuda"``;
    ``"cpu"`` runs the kernels' plain versions).  The table and the
    accumulators are updated in place; ``finalize`` materializes copies."""

    key_columns: Sequence[str]
    aggs: Sequence[AggSpec]
    max_groups: int
    morsel_rows: int = DEFAULT_MORSEL_ROWS
    update: str = "scatter"
    use_kernel: bool = False          # route updates through the segment kernel
    load_factor: float = 0.5
    pipeline: str = "scan"            # scan (stage launches) | host (reference loop)
    capacity: int | None = None       # probe-table slots; None → table_capacity
    raw_keys: bool = False            # single pre-hashed key column
    check_overflow: bool = True       # False = paper's perfect-estimate regime
    grow_bound: bool = False          # widen max_groups in-stream (no replay)
    collect_events: bool = False      # carry the obs event vector
    device: str | None = None

    def __post_init__(self):
        from repro_torch.kernels import fused_groupby as fk
        from repro_torch.kernels import table_ops

        if self.pipeline not in ("scan", "host"):
            raise ValueError(f"pipeline must be 'scan' or 'host', not {self.pipeline!r}")
        if self.raw_keys and len(self.key_columns) != 1:
            raise ValueError("raw_keys needs exactly one key column")
        self._fk = fk
        self._tops = table_ops
        self._device = resolve_device(self.device)
        cap = self.capacity or table_capacity(self.max_groups, self.load_factor)
        self._table = tk.make_table(cap, max_groups=self.max_groups, device=self._device)
        self._state = up.init_agg_state(expand_agg_specs(self.aggs), self.max_groups,
                                        device=self._device)
        self._value_cols = sorted({c for c, _ in self._state.specs if c is not None})
        if self.use_kernel:
            from repro_torch.kernels import ops as kops
            from repro_torch.kernels import segment_agg as sa

            strategy = self.update if self.update in ("scatter", "onehot") else "scatter"
            if strategy == "onehot" and self.max_groups > sa.MAX_ONEHOT_GROUPS:
                raise ValueError(
                    f"update='onehot' with kernel='scan_body' folds in one CTA's shared "
                    f"memory and takes at most {sa.MAX_ONEHOT_GROUPS} groups, not "
                    f"max_groups={self.max_groups}"
                )
            self._update_fn = kops.make_scan_update_fn(strategy=strategy)
        else:
            self._update_fn = up.get_update_fn(self.update)
        self._overflowed = False  # host mirror of a launch's overflow
        self._events = (obs_metrics.zero_event_vector(self._device)
                        if self.collect_events else None)
        self.migrations = 0
        self.bound_grows = 0

    # -- morsel-driven contract ---------------------------------------------
    def consume(self, chunk: Table) -> None:
        """Consume one chunk (any row count; morselized here).  A boolean
        ``__mask__`` column marks filtered-out rows (their key becomes the
        EMPTY sentinel, which ticketing skips)."""
        self.poll(self.consume_async(chunk))

    def consume_async(self, chunk: Table):
        """Dispatch one chunk's ticket and update stages WITHOUT reading
        their control signals.  Returns a token for :meth:`poll` (in
        dispatch order), or ``None`` when there is nothing to poll (host
        pipeline, unchecked, or a stream poisoned by an overflow).  A chunk
        dispatched while an earlier one is paused re-checks the room at
        every morsel, so it commits nothing past the pause point until the
        host catches up."""
        if self.poisoned:
            return None  # finalize raises anyway
        if self.pipeline == "host":
            self._consume_host_loop(*self._morselize(chunk))
            return None
        km, vm = self.scan_morsels(chunk)
        todo = torch.ones((km.shape[0],), dtype=torch.int32, device=self._device)
        bound = self._table.max_groups
        info = self._run_stages(km, vm, todo, checked=self.check_overflow)
        if not self.check_overflow:
            return None
        return [km, vm, todo, info, bound]

    @property
    def poisoned(self) -> bool:
        """A checked stream whose bound overflowed: it consumes nothing
        more, and ``finalize`` raises."""
        return self._overflowed and self.check_overflow

    def _morselize(self, chunk: Table):
        moved = Table({k: torch.as_tensor(v).to(self._device)
                       for k, v in chunk.columns.items()})
        keys, cols = chunk_key_column(moved, self.key_columns, self.raw_keys)
        return morselize_chunk(keys, {c: cols[c] for c in self._value_cols},
                               self.morsel_rows)

    def scan_morsels(self, chunk: Table):
        """One chunk staged for the ticket stage: ``(km, vm)``, the key
        morsels and value planes :meth:`_kernel_morsels` gives (the solo
        path's staging, which ``executors.consume_batched`` shares)."""
        km, vm, _ = self._morselize(chunk)
        return self._kernel_morsels(km, vm)

    def room(self) -> tuple:
        """The ticket stage's §4.4 room check against the current table:
        ``(threshold, bound_slack)``."""
        t = self._table
        return int(self.load_factor * t.capacity), t.max_groups - self.morsel_rows

    def update_planes(self, tickets, vm) -> None:
        """The update stage: fold one launch's ticket vector into every
        accumulator plane (rows at -1 are parked)."""
        self._state = up.update_agg_state(
            self._state, tickets.reshape(-1),
            {c: v.reshape(-1) for c, v in vm.items()}, self._update_fn,
        )

    def _kernel_morsels(self, km, vm):
        """The morsels the ticket stage runs: on the card, a morsel past
        ``MAX_MORSEL_ROWS`` rows becomes ``k`` sub-morsels of ``ceil(M /
        k)`` rows (EMPTY / zero padded), so that CTAs share a large morsel;
        on the CPU the true morsels."""
        cap = self._fk.MAX_MORSEL_ROWS
        m = km.shape[1]
        if self._device.type != "cuda" or m <= cap:
            return km.contiguous(), vm
        k = math.ceil(m / cap)
        sub = math.ceil(m / k)
        pad = k * sub - m

        def split(x, fill):
            if pad:
                x = torch.cat([x, x.new_full((x.shape[0], pad), fill)], dim=1)
            return x.reshape(-1, sub).contiguous()

        return split(km, EMPTY_I32), {c: split(v, 0.0) for c, v in vm.items()}

    def _run_stages(self, km, vm, todo, *, checked):
        """One ticket launch over the todo morsels, then one update of every
        accumulator plane over the launch's ticket vector.  Returns the
        launch's info vector (not read here)."""
        threshold, bound_slack = self.room()
        tickets, info = self._fk.scan_ticket(
            self._table, km, todo, checked=checked,
            grow_bound=checked and self.grow_bound, threshold=threshold,
            bound_slack=bound_slack, collect_events=self.collect_events,
            events=self._events,
        )
        self.update_planes(tickets, vm)
        return info

    def poll(self, token) -> None:
        """Resolve one in-flight chunk: read its info vector (ONE blocking
        device round trip) and run pause → grow → resume until every morsel
        of the chunk is committed."""
        if token is None:
            return
        km, vm, todo, info, bound = token
        fk = self._fk
        replayed = -1  # morsel already replayed without growth
        while True:
            row = info[0].tolist()
            if row[fk.INFO_COUNT] > bound:
                self._overflowed = True
                return  # poisoned: finalize raises instead of truncating
            if not row[fk.INFO_HALTED]:
                return
            start = row[fk.INFO_FIRST_HALT]
            with obs_trace.span("pause_migrate_resume", morsel=start):
                if not self._grow(self.morsel_rows) and start == replayed:
                    # the pause survived a replay with no growth condition met
                    # (an earlier chunk's poll already grew, or a probe
                    # cluster saturated): double, so the replay progresses
                    self._table = self._tops.migrate(self._table, 2 * self._table.capacity)
                    self.migrations += 1
                replayed = start
                bound = self._table.max_groups
                info = self._run_stages(km, vm, todo, checked=True)

    def _grow(self, morsel_rows: int) -> bool:
        """Host side of a pause: widen the bound (``grow_bound`` headroom
        crossed), the capacity (load factor crossed), or both.  False when
        neither condition holds against the CURRENT state."""
        count = int(self._table.count)
        grew = False
        cap_before = self._table.capacity
        if self.grow_bound and count > self.max_groups - morsel_rows:
            new_max = max(4 * self.max_groups, count + morsel_rows, 64)
            self._table = resize.grow_bound(self._table, new_max, self.load_factor,
                                            relocate=self._tops.migrate)
            self._state = up.grow_agg_state(self._state, new_max)
            self.max_groups = new_max
            self.bound_grows += 1
            grew = True
        if count > self.load_factor * self._table.capacity:
            self._table = self._tops.migrate(self._table, 2 * self._table.capacity)
            grew = True
        if self._table.capacity != cap_before:
            self.migrations += 1  # a bound grow may migrate too
        return grew

    def _consume_host_loop(self, km, vm, num) -> None:
        """The reference pipeline: one Python iteration per morsel with a
        blocking resize check, GET_OR_INSERT (``kernels.table_ops``: the
        card's kernel on CUDA tensors, ``core.ticketing`` on the CPU), a
        saturation replay, and one update.  With
        ``check_overflow=False`` the checks are skipped (fixed capacity,
        rows past a saturated table drop)."""
        for i in range(num):
            if self.check_overflow:
                if self.grow_bound:
                    self._grow(km.shape[1])
                else:
                    cap_before = self._table.capacity
                    self._table = resize.maybe_resize(self._table, self.load_factor,
                                                      relocate=self._tops.migrate)
                    if self._table.capacity != cap_before:
                        self.migrations += 1
            tickets, self._table = self._tops.get_or_insert(self._table, km[i])
            while self.check_overflow and bool(((tickets < 0) & (km[i] != EMPTY_I32)).any()):
                self._table = self._tops.migrate(self._table, 2 * self._table.capacity)
                self.migrations += 1
                tickets, self._table = self._tops.get_or_insert(self._table, km[i])
            self._state = up.update_agg_state(
                self._state, tickets, {c: v[i] for c, v in vm.items()}, self._update_fn,
            )

    def finalize(self) -> Table:
        """Materialize keys in ticket order + one column per aggregate.
        Raises :class:`GroupByOverflowError` if the stream held more than
        ``max_groups`` distinct keys (a truncated result would be silent
        data loss).  Idempotent."""
        if self.check_overflow and (self._overflowed or bool(self._table.overflowed)):
            raise GroupByOverflowError(
                f"GROUP BY overflow: {int(self._table.count)} distinct keys "
                f"exceed max_groups={self.max_groups}; groups past the bound "
                "were dropped. Re-run with a larger max_groups (or a better "
                "cardinality estimate)."
            )
        return build_result_table(
            self.aggs, self._state.get, self._table.key_by_ticket,
            self._table.count, self._table.max_groups,
        )

    @property
    def num_groups(self):
        return self._table.count

    def load_state(self, table: tk.TicketTable, state: up.AggState) -> None:
        """Continue from a carried table and its accumulators (for example
        a JAX operator's, through :func:`scan_state_from_numpy`)."""
        if state.num_groups != table.max_groups:
            raise ValueError(f"{state.num_groups} accumulator slots for a bound of "
                             f"{table.max_groups}")
        if state.specs != self._state.specs:
            raise ValueError(f"accumulator specs {state.specs} != {self._state.specs}")
        self._table = tk.TicketTable(*(t.to(self._device) for t in table))
        self._state = up.AggState(state.specs, tuple(a.to(self._device) for a in state.accs))
        self.max_groups = table.max_groups

    def event_counts(self) -> dict:
        """The device event vector (one device round trip) + host growth
        counters + table occupancy; zeros for the device half when the
        operator was built uninstrumented."""
        if self._events is not None:
            out = obs_metrics.event_vector_to_dict(self._events.cpu().numpy())
        else:
            out = {name: 0 for name in obs_metrics.EVENT_NAMES}
            out["probe_hist"] = [0] * obs_metrics.PROBE_HIST_BUCKETS
        count = int(self._table.count)
        out["migrations"] = self.migrations
        out["bound_grows"] = self.bound_grows
        out["num_groups"] = count
        out["table_capacity"] = self._table.capacity
        out["table_load_factor"] = count / self._table.capacity
        return out


def scan_state_from_numpy(table_arrays: Sequence[np.ndarray], specs: tuple,
                          accs: Sequence[np.ndarray], device=None):
    """A JAX operator's state as numpy arrays → the port's ``(TicketTable,
    AggState)``: ``table_arrays`` in ``TicketTable`` field order (keys and
    key_by_ticket as uint32, whose bits become int32; tickets; count;
    overflowed) and one accumulator per spec."""
    keys, tickets, kbt, count, overflowed = (np.asarray(a) for a in table_arrays)

    def t(a, dtype):
        a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(dtype, copy=False)
        return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)

    table = tk.TicketTable(
        keys=t(keys, np.int32), tickets=t(tickets, np.int32),
        key_by_ticket=t(kbt, np.int32), count=t(count, np.int32).reshape(()),
        overflowed=t(overflowed, np.bool_).reshape(()),
    )
    state = up.AggState(tuple(specs), tuple(t(a, np.float32) for a in accs))
    return table, state


def groupby(
    table: Table,
    keys: Sequence[str],
    aggs: Sequence[AggSpec],
    *,
    max_groups: int | None = None,
    update: str | None = None,
    morsel_rows: int = DEFAULT_MORSEL_ROWS,
    strategy: str = "auto",
    saturation: str | None = None,
    device: str | None = None,
) -> Table:
    """One-shot GROUP BY with adaptive strategy selection through the plan
    API (the paper's estimate → choose → run): ``strategy="auto"`` samples
    the keys, picks the route (the reference's Table 1 policy; on a CUDA
    device the scan route with the segment kernel, see
    ``engine.executors.cuda_route``) and runs it.  ``saturation=None``
    defers to the plan API's default: ``grow`` when ``max_groups`` is
    estimated, ``raise`` for an explicit bound.  ``device``: None →
    ``"cuda"``."""
    from repro_torch.engine.plan_api import ExecutionPolicy, GroupByPlan, execute

    plan = GroupByPlan(
        keys=tuple(keys), aggs=tuple(aggs), strategy=strategy,
        max_groups=max_groups, saturation=saturation,
        execution=ExecutionPolicy(update=update, morsel_rows=morsel_rows, device=device),
    )
    return execute(plan, table)
