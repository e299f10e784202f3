"""Executors: the seam every GROUP BY plan lowers through.

Port of ``repro.engine.executors``.  ``make_executor(plan)`` turns a
:class:`GroupByPlan` into an object with the streaming protocol

    open() → consume(chunk)* → finalize() → Table

plus ``consume_async(chunk) → token`` / ``poll(token)`` (the double-
buffered ingest seam the :class:`StreamHandle` drives) and an idempotent
``finalize`` (a mid-stream ``snapshot()``).

The port runs three routes of ``strategy="concurrent"`` with hash
ticketing and an explicit ``max_groups`` so far, each with the raise /
grow / unchecked saturation policies:

  * ``kernel`` ∈ {None, "off", "scan_body"} (and the ``use_kernel=True``
    alias) — :class:`_ScanExecutor`: the scan route's
    :class:`~repro_torch.engine.groupby.GroupByOperator`, a ticket launch
    and one update per accumulator plane per chunk against a carried table,
    with the update strategies of ``core/updates.py`` (``"off"``) or the
    segment kernel (``"scan_body"``);
  * ``kernel="fused"`` — :class:`_FusedExecutor`: one kernel tickets and
    aggregates against a table carried across chunks, with the §4.4
    pause → grow → resume protocol;
  * ``kernel="split"`` (legacy ``strategy="pallas"``) —
    :class:`_PallasExecutor`: the ticket kernel and one segment kernel per
    aggregate plane run over each chunk against a fresh table, and the
    chunk's bounded partial merges into a carried table.

Every other plan raises ``NotImplementedError`` naming the ROADMAP item
that ports it; none quietly runs something else.

Device rule: the executor runs on ``ExecutionPolicy.device`` and moves each
chunk there.  ``device=None`` means ``"cuda"`` and raises ``RuntimeError``
when no CUDA device exists; only an explicit ``device="cpu"`` runs on the
CPU (the kernels' plain versions).
"""
from __future__ import annotations

import warnings
from dataclasses import replace

import torch

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32, table_capacity
from repro_torch.engine.columns import Table, chunk_key_column
from repro_torch.engine.groupby import (
    GroupByOperator,
    GroupByOverflowError,
    build_result_table,
    expand_agg_specs,
    resolve_device,
)
from repro_torch.engine.plan_api import GroupByPlan, SaturationPolicy, value_columns
from repro_torch.obs import metrics as obs_metrics

# ---------------------------------------------------------------------------
# kernel selection


_ALIAS_WARNED: set = set()


def _warn_alias_once(alias: str, repl: str) -> None:
    if alias in _ALIAS_WARNED:
        return
    _ALIAS_WARNED.add(alias)
    warnings.warn(
        f"{alias} is deprecated; use ExecutionPolicy.kernel={repl!r}",
        DeprecationWarning,
        stacklevel=4,
    )


def reset_kernel_alias_warnings() -> None:
    """Re-arm the once-per-process alias warnings (test helper)."""
    _ALIAS_WARNED.clear()


def normalize_kernel(plan: GroupByPlan) -> GroupByPlan:
    """Lower the reference's legacy kernel spellings onto
    ``ExecutionPolicy.kernel``, warning once per process per alias:
    ``strategy="pallas"`` → ``concurrent`` + ``kernel="split"`` and
    ``use_kernel=True`` → ``kernel="scan_body"`` (an explicit ``kernel``
    wins over either alias).  Idempotent."""
    ex = plan.execution
    strategy, kernel, changed = plan.strategy, ex.kernel, False
    if strategy == "pallas":
        _warn_alias_once('strategy="pallas"', "split")
        strategy = "concurrent"
        kernel = kernel or "split"
        changed = True
    if ex.use_kernel:
        _warn_alias_once("ExecutionPolicy.use_kernel", "scan_body")
        kernel = kernel or "scan_body"
        changed = True
    if changed:
        plan = replace(plan, strategy=strategy,
                       execution=replace(ex, kernel=kernel, use_kernel=False))
    return plan


# Where each plan outside the ported slice will be ported (ROADMAP.md,
# "Modules to port").
_STRATEGY_ITEM = {
    "auto": "item 5 (auto: _ResolvingExecutor and the planner)",
    "hybrid": "item 5 (the other single-device strategies)",
    "partitioned": "item 5 (the other single-device strategies)",
    "sharded": "item 9 (multi-device sharding)",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md 'Modules to "
        f"port' {item}"
    )


# update strategies of the split route's segment kernel
_SPLIT_UPDATES = ("scatter", "onehot")


def make_executor(plan: GroupByPlan):
    """Lower a plan to its executor (the scan, fused and split concurrent
    hash routes are ported; see the module docstring)."""
    plan = normalize_kernel(plan)
    ex = plan.execution
    kernel = ex.kernel
    if kernel in ("split", "fused") and (plan.strategy not in ("auto", "concurrent")
                                         or ex.ticketing != "hash"
                                         or plan.saturation == SaturationPolicy.SPILL):
        # invalid in the reference too, not merely unported
        raise ValueError(
            f"kernel={kernel!r} runs on the concurrent hash pipeline: it takes "
            "strategy 'auto' or 'concurrent', ticketing='hash' and no "
            "saturation='spill'"
        )
    if kernel == "split" and (ex.update or "scatter") not in _SPLIT_UPDATES:
        raise ValueError(
            f"kernel='split' takes update in {_SPLIT_UPDATES}, not {ex.update!r}"
        )
    if plan.saturation == SaturationPolicy.SPILL:
        # the reference's two rejections (repro.engine.executors.make_executor)
        if plan.strategy not in ("auto", "concurrent"):
            raise ValueError(
                "saturation='spill' runs on the concurrent hash pipeline; "
                f"strategy {plan.strategy!r} does not support spilling"
            )
        if plan.strategy == "concurrent" and ex.ticketing != "hash":
            raise ValueError(
                "saturation='spill' requires ticketing='hash' (the hot "
                "table is the probe table the spill router classifies "
                "against)"
            )
    for unported, what, item in (
        (plan.saturation == SaturationPolicy.SPILL, "saturation='spill'",
         "item 6 (out-of-core spill)"),
        (plan.strategy != "concurrent", f"strategy={plan.strategy!r}",
         _STRATEGY_ITEM.get(plan.strategy)),
        (plan.max_groups is None, "max_groups=None (an estimated bound)",
         "item 5 (auto: _ResolvingExecutor and the planner)"),
        (ex.ticketing != "hash", f"ticketing={ex.ticketing!r}",
         "item 5 (_SortExecutor and _DirectExecutor)"),
    ):
        if unported:
            raise _not_ported(what, item)
    device = resolve_device(ex.device)
    if plan.saturation is None:
        plan = replace(plan, saturation=SaturationPolicy.RAISE)
    if kernel == "split":
        return _PallasExecutor(plan, device)
    if kernel == "fused":
        return _FusedExecutor(plan, device)
    return _ScanExecutor(plan, device)


# ---------------------------------------------------------------------------
# shared helpers


def _instrument(plan: GroupByPlan) -> bool:
    """Per-plan instrumentation: an explicit ``ExecutionPolicy.instrument``
    wins; ``None`` follows the global ``obs.metrics`` enable flag."""
    ins = plan.execution.instrument
    return obs_metrics.enabled() if ins is None else bool(ins)


class _ExecutorBase:
    """Default streaming protocol and the unified stats schema."""

    peak_buffered_chunks = 0  # chunks retained beyond the in-flight window
    peak_retained_bytes = 0   # host bytes retained beyond the in-flight window
    strategy_label = "?"      # labeled-series key for registry publishing

    def open(self) -> None:
        pass

    def consume_async(self, chunk: Table):
        self.consume(chunk)
        return None

    def poll(self, token) -> None:
        pass

    def memory_stats(self) -> dict:
        return {
            "peak_buffered_chunks": self.peak_buffered_chunks,
            "peak_retained_bytes": self.peak_retained_bytes,
        }

    def device_table_bytes(self) -> int:
        return 0

    def event_counts(self) -> dict | None:
        return None

    def stats(self) -> dict:
        """THE unified executor stats schema (``repro.obs/v1``): memory
        keys at the top level, nested ``memory`` / ``device`` sections, and
        the event counters under ``device`` when instrumented (published
        into the registry, delta-based)."""
        mem = self.memory_stats()
        out = dict(mem)
        out["schema"] = "repro.obs/v1"
        out["strategy"] = self.strategy_label
        out["memory"] = {
            "peak_buffered_chunks": mem.get("peak_buffered_chunks", 0),
            "peak_retained_bytes": mem.get("peak_retained_bytes", 0),
        }
        dev = {"device_table_bytes": self.device_table_bytes()}
        ev = self.event_counts()
        if ev is not None:
            dev.update(ev)
            self.publish(ev)
        out["device"] = dev
        return out

    def publish(self, ev: dict | None = None) -> None:
        """Push the counters into the process-wide registry as labeled
        series; delta-based and a no-op while the registry is disabled."""
        if not obs_metrics.enabled():
            return
        if ev is None:
            ev = self.event_counts()
        if ev is None:
            return
        pub = getattr(self, "_obs_publisher", None)
        if pub is None:
            pub = obs_metrics.EventPublisher(strategy=self.strategy_label)
            self._obs_publisher = pub
        gauges = ("table_capacity", "table_load_factor", "num_groups")
        totals = {
            f"groupby.{k}": v for k, v in ev.items()
            if k not in gauges and isinstance(v, (int, float))
        }
        if "probe_hist" in ev:
            totals["groupby.probe_len"] = ev["probe_hist"]
        pub.publish(totals)
        for g in gauges:
            if g in ev:
                obs_metrics.gauge(
                    f"groupby.{g}", strategy=self.strategy_label
                ).set(ev[g])


def _chunk_keys_values(plan: GroupByPlan, chunk: Table, device: torch.device):
    """Canonicalize one chunk on ``device``: the int32 key column (combined
    or raw, ``__mask__`` applied) + float32 value columns."""
    moved = Table({k: torch.as_tensor(v).to(device) for k, v in chunk.columns.items()})
    keys, cols = chunk_key_column(moved, plan.keys, plan.raw_keys)
    vals = {c: cols[c].reshape(-1).to(torch.float32) for c in value_columns(plan.aggs)}
    return keys, vals


def _next_bound(max_groups: int, rows: int, issued: int | None = None) -> int:
    """THE grow rule.  With the true cardinality known (``issued``) jump
    straight to it; blind retries grow 4× (geometric → O(log) replays).
    ``rows`` always suffices, so the recovery loop terminates."""
    if issued is not None:
        return min(max(issued, 64), max(rows, issued))
    return min(max(4 * max_groups, 64), rows)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _overflow_error(count, max_groups) -> GroupByOverflowError:
    return GroupByOverflowError(
        f"GROUP BY overflow: {count} distinct keys exceed "
        f"max_groups={max_groups}; groups past the bound were dropped. "
        "Use SaturationPolicy.GROW, a larger max_groups, or a better "
        "cardinality estimate."
    )


# ---------------------------------------------------------------------------
# concurrent: the scan route (streams natively)


class _ScanExecutor(_ExecutorBase):
    """Strategy ``concurrent`` with hash ticketing and ``kernel`` ∈ {None,
    "off", "scan_body"}: a thin saturation-policy shell around the scan
    route's :class:`GroupByOperator`.  Streaming-native, no chunk is
    retained: ``grow`` rides the operator's in-stream bound growth (pause
    → widen ``key_by_ticket`` + accumulators → resume at the paused
    morsel)."""

    strategy_label = "concurrent"

    def __init__(self, plan: GroupByPlan, device: torch.device):
        self._plan = plan
        p, ex = plan, plan.execution
        self._op = GroupByOperator(
            key_columns=list(p.keys), aggs=list(p.aggs), max_groups=p.max_groups,
            morsel_rows=ex.morsel_rows, update=ex.update or "scatter",
            use_kernel=ex.kernel == "scan_body", load_factor=ex.load_factor,
            pipeline=ex.pipeline, capacity=ex.capacity, raw_keys=p.raw_keys,
            check_overflow=p.saturation != SaturationPolicy.UNCHECKED,
            grow_bound=p.saturation == SaturationPolicy.GROW,
            collect_events=_instrument(plan), device=str(device),
        )

    def consume(self, chunk: Table) -> None:
        self._op.consume(chunk)

    def consume_async(self, chunk: Table):
        return self._op.consume_async(chunk)

    def poll(self, token) -> None:
        self._op.poll(token)

    def finalize(self) -> Table:
        out = self._op.finalize()
        self.publish()
        return out

    def device_table_bytes(self) -> int:
        return resize.table_nbytes(self._op._table) + sum(
            _nbytes(a) for a in self._op._state.accs
        )

    def event_counts(self):
        return self._op.event_counts() if self._op.collect_events else None


# ---------------------------------------------------------------------------
# split: per-chunk kernel pipeline + a carried merge table

# how a chunk's raw partial of each kind merges into the carried accumulator
_MERGE_KIND = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


class _IncrementalMergeExecutor(_ExecutorBase):
    """Streaming shell for a pipeline that is a one-shot program over its
    input (here: kernel launches against a table made fresh per chunk):
    run it over EACH chunk, then merge the chunk's bounded partial (at most
    ``max_groups`` (key, partial) entries) into a carried ticket table +
    merge accumulators (``get_or_insert`` + ``scatter_update``).  State is
    O(max_groups); no chunks are retained.

    Saturation: the per-chunk pipeline recovers chunk-locally under GROW
    (one blocking sync per chunk); the carried UNION bound grows by padding
    ``key_by_ticket`` and the merge accumulators (tickets are stable) before
    a chunk that could overflow it merges.  RAISE accumulates sticky
    device-side flags and checks them once at finalize; UNCHECKED never
    checks and truncates.

    The FIRST chunk's raw partial is held un-merged and lowered into the
    carried table only when a second chunk arrives, so a single-chunk run
    materializes the pipeline's native layout (its own ticket order)."""

    def __init__(self, plan: GroupByPlan, device: torch.device):
        self._plan = plan
        self._device = device
        self._specs = expand_agg_specs(plan.aggs)
        self._max_groups = plan.max_groups          # carried union bound
        self._chunk_bound = plan.max_groups         # per-chunk pipeline bound
        self._rows = 0
        self._host_count = 0                        # union count mirror (GROW)
        self._ovf = torch.zeros((), dtype=torch.bool, device=device)  # sticky loss
        self._pending = None                        # first chunk's raw partial
        self._merged_any = False
        self._table = tk.make_table(
            table_capacity(plan.max_groups, plan.execution.load_factor),
            max_groups=plan.max_groups, device=device,
        )
        self._accs = {
            spec: up.init_acc(plan.max_groups, spec[1], device=device)
            for spec in self._specs
        }

    # subclass: run the pipeline over one chunk, honoring (and under GROW
    # growing) ``self._chunk_bound``; returns (key_by_ticket, {spec: raw
    # partial acc}, count, device loss flag)
    def _chunk_partial(self, keys, vals):
        raise NotImplementedError

    def _grow_carried(self, new_max: int) -> None:
        self._table = resize.grow_bound(
            self._table, new_max, self._plan.execution.load_factor
        )
        for spec, acc in self._accs.items():
            pad = up.init_acc(new_max - acc.shape[0], spec[1], device=self._device)
            self._accs[spec] = torch.cat([acc, pad])
        self._max_groups = new_max

    def _merge(self, partial) -> None:
        grow = self._plan.saturation == SaturationPolicy.GROW
        kbt, partials, count, ovf = partial
        if grow:
            issued = int(count)
            if self._host_count + issued > self._max_groups:
                self._grow_carried(
                    max(4 * self._max_groups, self._host_count + issued, 64)
                )
        tickets, self._table = tk.get_or_insert(self._table, kbt)
        for spec, acc in partials.items():
            self._accs[spec] = up.scatter_update(
                self._accs[spec], tickets, acc, kind=_MERGE_KIND[spec[1]]
            )
        if grow:
            self._host_count = int(self._table.count)
        else:
            self._ovf = self._ovf | ovf
        self._merged_any = True

    def consume(self, chunk: Table) -> None:
        keys, vals = _chunk_keys_values(self._plan, chunk, self._device)
        self._rows += int(keys.shape[0])
        partial = self._chunk_partial(keys, vals)
        if not self._merged_any and self._pending is None:
            # single-chunk fast path: hold the native layout; the held
            # partial is retained state beyond the in-flight window
            self._pending = partial
            kbt, partials, _, _ = partial
            self.peak_retained_bytes = max(
                self.peak_retained_bytes,
                _nbytes(kbt) + sum(_nbytes(a) for a in partials.values()),
            )
            return
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._merge(pending)
        self._merge(partial)

    def finalize(self) -> Table:
        p = self._plan
        checked = p.saturation != SaturationPolicy.UNCHECKED
        if self._pending is not None and not self._merged_any:
            # exactly one chunk: the pipeline's own materialization
            kbt, partials, count, ovf = self._pending
            if checked and bool(ovf):
                raise _overflow_error(int(count), self._chunk_bound)
            return build_result_table(
                p.aggs, lambda c, k: partials[(c, k)], kbt, count,
                self._chunk_bound,
            )
        if checked and (bool(self._ovf) or bool(self._table.overflowed)):
            raise _overflow_error(int(self._table.count), self._max_groups)
        return build_result_table(
            p.aggs, lambda c, k: self._accs[(c, k)],
            self._table.key_by_ticket, self._table.count, self._max_groups,
        )

    def device_table_bytes(self) -> int:
        n = resize.table_nbytes(self._table) + sum(
            _nbytes(a) for a in self._accs.values()
        )
        if self._pending is not None:
            kbt, partials, _, _ = self._pending
            n += _nbytes(kbt) + sum(_nbytes(a) for a in partials.values())
        return n


class _PallasExecutor(_IncrementalMergeExecutor):
    """``kernel="split"`` (legacy ``strategy="pallas"``): the ticket kernel
    and one segment kernel per aggregate plane (kernels/ops.py) launched per
    chunk.  The ticket kernel's table lives for one launch, so each chunk's
    bounded result merges into the carried table.  GROW re-launches the
    CHUNK with a grown bound (``_next_bound``) or a doubled capacity — never
    the stream.  ``relaunches`` / ``bound_grows`` / ``capacity_grows`` count
    those re-launches."""

    strategy_label = "pallas"

    def __init__(self, plan: GroupByPlan, device: torch.device):
        super().__init__(plan, device)
        ex = plan.execution
        self._capacity = ex.capacity or table_capacity(plan.max_groups, ex.load_factor)
        self.relaunches = 0
        self.bound_grows = 0
        self.capacity_grows = 0

    def _chunk_partial(self, keys, vals):
        from repro_torch.kernels import ops as kops

        p, ex = self._plan, self._plan.execution
        bound, capacity = self._chunk_bound, self._capacity
        while True:
            tickets, kbt, count = kops._ticket(
                keys, capacity=capacity, max_groups=bound, morsel_size=ex.morsel_size,
            )
            dropped_dev = ((tickets < 0) & (keys != EMPTY_I32)).any()
            ovf = (count > bound) | dropped_dev
            if p.saturation != SaturationPolicy.GROW:
                break
            issued = int(count)
            dropped = bool(dropped_dev)
            if issued <= bound and not dropped:
                break
            # the two overflow causes recover independently: an undersized
            # bound grows max_groups (rows-bounded), a saturated probe table
            # doubles capacity
            grew = False
            if issued > bound and bound < self._rows:
                bound = _next_bound(bound, self._rows)
                self.bound_grows += 1
                grew = True
            if dropped:
                capacity = max(table_capacity(bound, ex.load_factor), 2 * capacity)
                self.capacity_grows += 1
                grew = True
            if not grew:
                raise GroupByOverflowError(
                    f"GROUP BY overflow: {issued} tickets issued against "
                    f"max_groups={bound} and growth cannot make progress."
                )
            self.relaunches += 1
        self._chunk_bound, self._capacity = bound, capacity
        partials = {}
        for col, kind in self._specs:
            v = vals[col] if col else torch.ones(keys.shape, dtype=torch.float32,
                                                 device=self._device)
            partials[(col, kind)] = kops._segment_aggregate(
                tickets, v, num_groups=bound, kind=kind,
                strategy=ex.update or "scatter", morsel_size=ex.morsel_size,
            )
        return kbt, partials, count, ovf


# ---------------------------------------------------------------------------
# fused: ticketing + aggregation in one kernel, table carried across chunks


class _FusedExecutor(_ExecutorBase):
    """``kernel="fused"``: ticketing and aggregation fused in one kernel
    (kernels/fused_groupby.py) whose table + accumulators persist ACROSS
    chunks as carried device state.  Nothing is rebuilt or merged per
    chunk.

    ``kernel_programs > 1`` runs per-program local tables; ``finalize``
    performs the second-level merge into one ticket space.  Saturation
    rides the kernel's §4.4 info vector and its per-morsel commit flags:
    ``poll`` reads the info once per chunk and relaunches the chunk on its
    own ``todo`` mask, which the kernel cleared for every morsel it
    committed — growing bound/capacity with ``grow_fused_state`` first
    (migration keeps tickets, so committed aggregates are untouched) only
    when the count crossed a threshold or a morsel saturated.  A halt with
    room left relaunches on the same state, so morsels that raced for the
    bound never grow the table (the kernel makes such halts rare: a
    reservation that does not fit waits while the count has room).  RAISE
    surfaces the overflow; UNCHECKED never reads the info vector.

    The kernel updates the state IN PLACE; every launch works on the
    newest state and only on morsels still todo, so no committed morsel is
    applied twice."""

    strategy_label = "fused"

    def __init__(self, plan: GroupByPlan, device: torch.device):
        from repro_torch.kernels import fused_groupby as fk

        self._fk = fk
        self._plan = plan
        self._device = device
        ex = plan.execution
        self._specs = expand_agg_specs(plan.aggs)
        self._kinds = tuple(k for _, k in self._specs)
        self._vcols = tuple(value_columns(plan.aggs))
        # accumulator → value-plane map (-1: count reads no plane)
        self._kspecs = tuple(
            (-1 if kind == "count" or not col else self._vcols.index(col), kind)
            for col, kind in self._specs
        )
        self._m = ex.morsel_size
        self._P = ex.kernel_programs
        self._lf = ex.load_factor
        self._checked = plan.saturation != SaturationPolicy.UNCHECKED
        self._grow = plan.saturation == SaturationPolicy.GROW
        self._collect = _instrument(plan)
        self._migrations = 0
        self._bound_grows = 0
        self._state = fk.init_fused_state(
            capacity=ex.capacity or table_capacity(plan.max_groups, self._lf),
            max_groups=plan.max_groups,
            kinds=self._kinds,
            programs=self._P,
            device=device,
        )
        self._info = None        # (P, INFO_LEN) control vector, latest launch
        # FIFO of launches whose halt signals are unread: [km, vm, todo,
        # info, grow_gen].  Prefetch dispatches chunk k+1 before chunk k's
        # poll, so a grow pause must replay EVERY chunk launched since the
        # last drain, each on its own todo mask.
        self._pending: list = []
        self._grow_gen = 0       # bumps per grow; stamps pending launches

    def _morselize(self, keys, vals):
        """Pad + reshape one chunk into (P·npm, M) key morsels and
        (V, P·npm, M) value planes; program ``p`` owns the contiguous
        morsel range [p·npm, (p+1)·npm)."""
        n = keys.shape[0]
        pad = (-n) % (self._m * self._P)
        k = keys
        if pad:
            k = torch.cat([k, k.new_full((pad,), EMPTY_I32)])
        km = k.reshape(-1, self._m).contiguous()
        if self._vcols:
            planes = []
            for c in self._vcols:
                v = vals[c]
                if pad:
                    v = torch.cat([v, v.new_zeros((pad,))])
                planes.append(v.reshape(-1, self._m))
            vm = torch.stack(planes).contiguous()
        else:
            # the kernel's value operand needs ≥1 plane; count-only plans
            # never read it (plane index -1)
            vm = torch.zeros((1, km.shape[0], self._m), dtype=torch.float32,
                             device=self._device)
        return km, vm

    def _launch(self, km, vm, todo) -> None:
        st = self._state
        self._state, self._info = self._fk.fused_consume(
            st, km, vm, todo,
            specs=self._kspecs,
            checked=self._checked,
            grow_bound=self._grow,
            # NOT clamped at 0: a bound below the morsel size must pause the
            # very first morsel (count 0 > negative slack) — running it
            # would issue tickets past the bound and lose their keys
            threshold=int(self._lf * st.capacity),
            bound_slack=st.max_groups - self._m,
            collect_events=self._collect,
        )

    def consume_async(self, chunk: Table):
        keys, vals = _chunk_keys_values(self._plan, chunk, self._device)
        km, vm = self._morselize(keys, vals)
        todo = torch.ones((km.shape[0],), dtype=torch.int32, device=self._device)
        self._launch(km, vm, todo)
        if self._checked:
            self._pending.append([km, vm, todo, self._info, self._grow_gen])
        return self._info

    def consume(self, chunk: Table) -> None:
        self.poll(self.consume_async(chunk))

    def poll(self, token) -> None:
        """Drain the halt signals of EVERY launch since the last drain, in
        dispatch order (§4.4, host side).  A clean launch costs one info
        read; a halted one is relaunched on its todo mask, after a grow when
        the count crossed a threshold or a morsel saturated.  An entry
        halted under a state the queue has since grown is relaunched once
        before growing again (``_grow_gen``), so a burst of stale halts
        cannot cascade into spurious doublings.  Zero reads when
        UNCHECKED."""
        if not self._checked:
            return
        fk = self._fk
        while self._pending:
            entry = self._pending[0]
            while True:
                km, vm, todo, inf, gen = entry
                info = inf.cpu().numpy()
                if not (info[:, fk.INFO_HALTED] != 0).any():
                    break
                cmax = int(info[:, fk.INFO_COUNT].max())
                if not self._grow:
                    raise _overflow_error(cmax, self._state.max_groups)
                sat = bool((info[:, fk.INFO_SAT] != 0).any())
                if gen == self._grow_gen and (sat or self._crossed(cmax)):
                    self._grow_state(cmax)
                self._launch(km, vm, todo)
                entry[3], entry[4] = self._info, self._grow_gen
            self._pending.pop(0)

    def _crossed(self, cmax: int) -> bool:
        """The count passed the load threshold or the bound's headroom (the
        kernel's pause rules with one CTA)."""
        st = self._state
        return cmax > int(self._lf * st.capacity) or cmax > st.max_groups - self._m

    def _grow_state(self, cmax: int) -> None:
        st = self._state
        new_g, new_c = st.max_groups, st.capacity
        if cmax > st.max_groups - self._m:
            # bound headroom: the blind-retry jump of the scan pipeline
            new_g = max(4 * st.max_groups, cmax + self._m, 64)
        if cmax > int(self._lf * st.capacity) or new_g == st.max_groups:
            # capacity pressure — or a mid-morsel saturation below both
            # thresholds (probe clustering): double so the replay progresses
            new_c = 2 * st.capacity
        new_c = max(new_c, table_capacity(new_g, self._lf))
        if new_g > st.max_groups:
            self._bound_grows += 1
        if new_c > st.capacity:
            self._migrations += 1
        self._state = self._fk.grow_fused_state(
            st, self._kinds, new_max_groups=new_g, new_capacity=new_c,
            load_factor=self._lf,
        )
        self._grow_gen += 1

    def _merged(self):
        counts = self._state.count.cpu().numpy()
        target = self._state.max_groups
        if self._P > 1:
            # the union of P local ticket spaces can exceed one local bound;
            # GROW widens the merge target, RAISE detects via the merged
            # table's own sticky overflow below
            total = int(counts.sum())
            if self._grow and total > target:
                target = total
        table, accs = self._fk.merge_fused_state(
            self._state, self._kinds, max_groups=target, load_factor=self._lf,
        )
        overflowed = bool(counts.max(initial=0) > self._state.max_groups)
        if self._checked and (overflowed or bool(table.overflowed)):
            raise _overflow_error(int(table.count), target)
        return table, accs, target

    def finalize(self) -> Table:
        self.poll(self._info)
        table, accs, bound = self._merged()
        acc_by_spec = dict(zip(self._specs, accs))
        out = build_result_table(
            self._plan.aggs, lambda c, k: acc_by_spec[(c, k)],
            table.key_by_ticket, table.count, bound,
        )
        self.publish()
        return out

    def device_table_bytes(self) -> int:
        return self._state.nbytes()

    def event_counts(self) -> dict | None:
        if not self._collect:
            return None
        vec = self._state.events.sum(dim=0).cpu().numpy()
        count = int(self._state.count.sum())
        out = obs_metrics.event_vector_to_dict(vec)
        out["migrations"] = self._migrations
        out["bound_grows"] = self._bound_grows
        out["num_groups"] = count
        out["table_capacity"] = self._state.capacity
        out["table_load_factor"] = count / self._state.capacity
        return out
