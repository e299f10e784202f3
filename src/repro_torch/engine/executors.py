"""Executors: the seam every GROUP BY plan lowers through.

Port of ``repro.engine.executors``.  ``make_executor(plan)`` turns a
:class:`GroupByPlan` into an object with the streaming protocol

    open() → consume(chunk)* → finalize() → Table

plus ``consume_async(chunk) → token`` / ``poll(token)`` (the double-
buffered ingest seam the :class:`StreamHandle` drives) and an idempotent
``finalize`` (a mid-stream ``snapshot()``).

The port runs these plans, each with the raise / grow / unchecked
saturation policies:

  * ``strategy="auto"`` or ``max_groups=None`` (the defaults) —
    :class:`_ResolvingExecutor`: samples each chunk's first keys into
    ``core.adaptive.RunningStats``, resolves the plan from the first
    chunk (:func:`resolve_plan_stats`: the reference's Table 1 policy,
    plus :func:`cuda_route` on a card) and escalates a hash pipeline to
    hybrid mid-stream when heavy hitters emerge;
  * ``strategy="concurrent"``, hash ticketing:
      - ``kernel`` ∈ {None, "off", "scan_body"} (and the ``use_kernel=True``
        alias) — :class:`_ScanExecutor`: the scan route's
        :class:`~repro_torch.engine.groupby.GroupByOperator`, a ticket
        launch and one update per accumulator plane per chunk against a
        carried table, with the update strategies of ``core/updates.py``
        (``"off"``) or the segment kernel (``"scan_body"``);
      - ``kernel="fused"`` — :class:`_FusedExecutor`: one kernel tickets
        and aggregates against a table carried across chunks, with the
        §4.4 pause → grow → resume protocol;
      - ``kernel="split"`` (legacy ``strategy="pallas"``) —
        :class:`_PallasExecutor`: the ticket kernel and one segment kernel
        per aggregate plane over each chunk against a fresh table, the
        chunk's bounded partial merged into a carried table;
  * ``strategy="concurrent"``, ``ticketing="direct"`` —
    :class:`_DirectExecutor`: ticket == key over a bounded domain, one
    update per plane per chunk into a carried accumulator;
  * ``strategy="concurrent"``, ``ticketing="sort"`` —
    :class:`_SortExecutor`: sorting is a pipeline breaker, so chunks
    buffer and ``finalize`` runs sort ticketing and the chosen update over
    the whole stream (the one one-shot executor);
  * ``strategy="hybrid"`` — :class:`_HybridExecutor`: heavy-hitter rows
    fold into registers (the ``hybrid_registers`` kernel on a card), the
    tail runs through the scan route's operator;
  * ``strategy="partitioned"`` — :class:`_PartitionedExecutor`: the
    Leis-style pre-aggregation (the ``preagg`` kernel on a card) →
    exchange → partition-wise pipeline per chunk, each chunk's partial
    merged into a carried table;
  * ``saturation="spill"`` — ``engine.spill.SpillExecutor``: the scan
    route with a bounded device residency and host-spilled cold
    partitions, merged exactly at ``finalize`` (``strategy="auto"``
    resolves to it through :class:`_ResolvingExecutor`).

``strategy="sharded"`` raises ``NotImplementedError`` naming ROADMAP item
9; no plan quietly runs something else.  Every executor but
:class:`_FusedExecutor` checkpoints through ``engine/elastic.py``
(``StreamHandle.save`` / ``GroupByPlan.restore``).

Device rule: the executor runs on ``ExecutionPolicy.device`` and moves each
chunk there.  ``device=None`` means ``"cuda"`` and raises ``RuntimeError``
when no CUDA device exists; only an explicit ``device="cpu"`` runs on the
CPU (the kernels' plain versions).
"""
from __future__ import annotations

import warnings
from dataclasses import replace

import numpy as np
import torch

from repro_torch.core import adaptive, resize
from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32, table_capacity, to_i32_bits
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
    """Lower a plan to its executor (see the module docstring).
    ``strategy="auto"`` (or an unset ``max_groups``) defers to
    :class:`_ResolvingExecutor`, which samples the first chunk's keys and
    re-dispatches: the paper's estimate → choose → run."""
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
    if plan.strategy in _STRATEGY_ITEM:
        raise _not_ported(f"strategy={plan.strategy!r}", _STRATEGY_ITEM[plan.strategy])
    device = resolve_device(ex.device)
    if plan.saturation is None:
        # THE saturation default: an estimated bound recovers (a sample
        # cannot see a long tail); an explicit bound is a caller contract
        plan = replace(plan, saturation=(
            SaturationPolicy.GROW if plan.max_groups is None
            else SaturationPolicy.RAISE
        ))
    if (plan.saturation == SaturationPolicy.SPILL and plan.strategy == "concurrent"
            and plan.max_groups is not None):
        from repro_torch.engine.spill import SpillExecutor

        return SpillExecutor(plan, device)
    if plan.strategy == "auto" or plan.max_groups is None:
        return _ResolvingExecutor(plan, device)
    if plan.strategy == "hybrid":
        return _HybridExecutor(plan, device)
    if plan.strategy == "partitioned":
        return _PartitionedExecutor(plan, device)
    if ex.ticketing == "sort":
        return _SortExecutor(plan, device)
    if ex.ticketing == "direct":
        return _DirectExecutor(plan, device)
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


def _single_agg(plan: GroupByPlan, strategy: str):
    if len(plan.aggs) != 1 or plan.aggs[0].kind == "mean":
        raise ValueError(
            f"strategy {strategy!r} supports exactly one non-mean aggregate "
            "per plan; use strategy='concurrent' for multi-aggregate queries"
        )
    return plan.aggs[0]


def _update_fn_of(ex):
    """The update a whole-chunk ticket vector folds through: with
    ``kernel="scan_body"`` the segment kernel (``update`` "onehot" or
    else "scatter"), as the scan route's operator runs it; otherwise the
    named strategy of ``core/updates.py``."""
    if ex.kernel == "scan_body":
        from repro_torch.kernels import ops as kops

        strategy = ex.update if ex.update in ("scatter", "onehot") else "scatter"
        return kops.make_scan_update_fn(strategy=strategy)
    return up.get_update_fn(ex.update or "scatter")


# ---------------------------------------------------------------------------
# auto resolution (estimate → choose → run → re-plan)

# cardinality and skew past which a hash pipeline takes the hybrid route
# (heavy hitters at high cardinality: paper Table 2's worst corner)
_HYBRID_TOP_FREQ = 0.25
_HYBRID_GROUPS = 4096


def _wants_hybrid(stats: adaptive.WorkloadStats) -> bool:
    return stats.est_top_freq >= _HYBRID_TOP_FREQ and stats.est_groups > _HYBRID_GROUPS


def cuda_route(plan: GroupByPlan, resolved: GroupByPlan) -> GroupByPlan:
    """THE route rule of a resolved plan on a CUDA device, the port's
    counterpart of the reference's off-TPU ``kernel_table_budget`` (which
    is 0, so the reference never picks ``fused`` off a TPU).

    When ``plan`` runs on CUDA (``ExecutionPolicy.device`` None or a CUDA
    device), its caller left ``kernel`` None and its ``update`` is None or
    ``"scatter"``, the resolved plan takes ``kernel="scan_body"`` and
    ``update="scatter"``, whichever of concurrent hash, direct or hybrid
    Table 1 picked.  That includes ``saturation="spill"``: it resolves to
    concurrent hash, so ``engine.spill.SpillExecutor`` runs its hot
    operator and its partition replays on scan_ticket + the segment
    kernel.  Every other plan keeps the reference's resolution,
    field for field.  Measured ground (chip_smoke phase 3 walls on one H100
    80GB HBM3 at 700.00 W, 2^24 rows in 8 chunks, PERF.md §5): body_* at
    0.0054–0.0083 s per stream against 0.0101–0.0669 s for ``kernel="off"``
    and 0.0044–0.2041 s for fused; the reference's pick for small
    cardinalities (``update="onehot"``, ``kernel`` None) took 0.64–0.71 s
    on the low class.  ``update="scatter"`` also keeps a GROW bound past
    ``segment_agg.MAX_ONEHOT_GROUPS`` legal under scan_body.  The route
    changes speed only, never the result map."""
    ex = plan.execution
    on_cuda = torch.device("cuda" if ex.device is None else ex.device).type == "cuda"
    if not on_cuda or ex.kernel is not None or ex.update not in (None, "scatter"):
        return resolved
    return replace(resolved, execution=replace(resolved.execution, kernel="scan_body",
                                               update="scatter"))


def resolve_plan_stats(plan: GroupByPlan, stats: adaptive.WorkloadStats) -> GroupByPlan:
    """Bind ``strategy="auto"`` / ``max_groups=None`` from workload
    statistics: the reference's rule (``core/adaptive.py``, the paper's
    Table 1 policy, plus the hybrid route for high cardinality under heavy
    hitters), then :func:`cuda_route`."""
    max_groups = plan.max_groups
    if max_groups is None:
        # 2× headroom over the estimate, never above the row count, never 0
        max_groups = max(1, min(max(stats.est_groups * 2, 64), max(stats.n_rows, 1)))
    strategy, execution = plan.strategy, plan.execution
    if strategy == "auto":
        if plan.saturation == SaturationPolicy.SPILL:
            strategy = "concurrent"
            update = execution.update or "scatter"
        elif _wants_hybrid(stats):
            strategy = "hybrid"
            update = execution.update or "scatter"
        else:
            choice = adaptive.choose_plan(
                stats, num_accumulators=len(expand_agg_specs(plan.aggs))
            )
            strategy = "concurrent"
            update = execution.update or (
                "sort_segment" if choice.ticketing == "sort" else choice.update
            )
            if (choice.ticketing == "direct" and execution.ticketing == "hash"
                    and plan.raw_keys):
                # bounded key domain: perfect-hash ticketing, ticket == key
                execution = replace(
                    execution, ticketing="direct",
                    key_domain=execution.key_domain or stats.key_domain,
                )
            elif (choice.kernel == "fused" and execution.kernel is None
                    and execution.ticketing == "hash"):
                execution = replace(execution, kernel="fused")
        execution = replace(execution, update=update)
    resolved = replace(plan, strategy=strategy, max_groups=max_groups, execution=execution)
    return cuda_route(plan, resolved)


def resolve_plan(plan: GroupByPlan, keys: torch.Tensor) -> GroupByPlan:
    """One-shot resolution from a key sample (the streaming resolver below
    carries :class:`adaptive.RunningStats` across chunks instead)."""
    stats = adaptive.sample_stats(keys, domain=plan.execution.key_domain)
    return resolve_plan_stats(plan, stats)


class _ResolvingExecutor(_ExecutorBase):
    """Defers strategy / bound resolution to the first consumed chunk,
    then carries :class:`adaptive.RunningStats` across the stream and
    RE-PLANS mid-stream: a hash-ticketed concurrent pipeline escalates to
    hybrid when the observed heavy-hitter mass crosses the planner
    threshold (the live operator is adopted in place, so nothing replays).

    Each chunk's first :attr:`SAMPLE_ROWS` keys go to the host once (one
    device round trip per chunk).  The first chunk reaches the resolved
    executor through the same ``consume_async`` seam the stream uses."""

    SAMPLE_ROWS = 4096

    def __init__(self, plan: GroupByPlan, device: torch.device):
        self._plan = plan
        self._device = device
        self._inner = None
        self._resolved = None
        self._stats = adaptive.RunningStats(domain=plan.execution.key_domain)
        self._escalated = False

    @property
    def peak_buffered_chunks(self) -> int:
        return self._inner.peak_buffered_chunks if self._inner else 0

    def memory_stats(self) -> dict:
        return self._inner.memory_stats() if self._inner else super().memory_stats()

    @property
    def strategy_label(self) -> str:
        return self._inner.strategy_label if self._inner else "auto"

    def device_table_bytes(self) -> int:
        return self._inner.device_table_bytes() if self._inner else 0

    def event_counts(self):
        return self._inner.event_counts() if self._inner else None

    def stats(self) -> dict:
        return self._inner.stats() if self._inner else super().stats()

    def _sample_keys(self, chunk: Table) -> torch.Tensor:
        head = Table({k: torch.as_tensor(v)[: self.SAMPLE_ROWS]
                      for k, v in chunk.columns.items()})
        keys, _ = chunk_key_column(head, self._plan.keys, self._plan.raw_keys)
        return keys

    def _observe(self, chunk: Table) -> None:
        stats = self._stats.update(self._sample_keys(chunk))
        if self._inner is None:
            self._resolved = resolve_plan_stats(self._plan, stats)
            self._inner = make_executor(self._resolved)
            self._inner.open()
        else:
            self._maybe_replan(stats)

    def _maybe_replan(self, stats: adaptive.WorkloadStats) -> None:
        """hash → hybrid escalation: the first chunk's sample missed
        heavy-hitter mass that the running sketch has now seen.  Only under
        GROW (the auto default): adoption inserts the heavy keys into the
        live table, which must be allowed to widen for them."""
        if (
            self._escalated
            or not isinstance(self._inner, _ScanExecutor)
            or self._resolved.saturation != SaturationPolicy.GROW
            or not _wants_hybrid(stats)
        ):
            return
        heavy = self._stats.heavy_keys[: self._plan.execution.num_registers]
        if not heavy:
            return
        hybrid_plan = replace(
            self._resolved, strategy="hybrid",
            execution=replace(self._resolved.execution,
                              heavy_keys=np.asarray(heavy, np.uint32)),
        )
        self._inner = _HybridExecutor.adopt(hybrid_plan, self._inner._op)
        self._escalated = True

    def consume(self, chunk: Table) -> None:
        self._observe(chunk)
        self._inner.consume(chunk)

    def consume_async(self, chunk: Table):
        self._observe(chunk)
        return self._inner.consume_async(chunk)

    def poll(self, token) -> None:
        # tokens stay valid across an escalation: hybrid adopts the SAME
        # operator the tokens were dispatched on
        self._inner.poll(token)

    def finalize(self) -> Table:
        if self._inner is None:
            raise ValueError("GroupByPlan executed over zero chunks")
        return self._inner.finalize()


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
# batched co-dispatch: N same-shape queries, ONE ticket launch per round
#
# The serving scheduler (serve/scheduler.py) co-schedules slot tasks that
# share a ``batch_key``.  For GROUP BY streams the key is ``batch_signature``
# below: plans with equal signatures run the scan route's operator with the
# same bound, capacity rule, morsel size, update and checks, so one chunk of
# each of N queries can share ONE ticket launch
# (``fused_groupby.scan_ticket_batched``) and one blocking read of its info
# rows, where solo stepping costs N launches and N reads.


def batch_signature(plan: GroupByPlan):
    """Hashable co-dispatch key, or ``None`` when the plan is ineligible.

    Eligible, as in the reference: the concurrent scan pipeline with hash
    ticketing and a fixed bound, ``kernel`` None or "off" and no
    ``use_kernel``, RAISE or UNCHECKED saturation, not instrumented.  GROW
    needs per-query host control flow mid-chunk, the kernel routes have
    launches of their own, sort / direct ticketing carry no probe table,
    and the batched launch counts no events.  The key also holds the
    device, so that a round's lanes live on one device."""
    if _instrument(plan):
        return None
    ex = plan.execution
    saturation = plan.saturation or (
        SaturationPolicy.GROW if plan.max_groups is None else SaturationPolicy.RAISE
    )
    if (
        plan.strategy != "concurrent"
        or plan.max_groups is None
        or ex.ticketing != "hash"
        or ex.pipeline != "scan"
        or ex.use_kernel
        or ex.kernel not in (None, "off")
        or saturation not in (SaturationPolicy.RAISE, SaturationPolicy.UNCHECKED)
    ):
        return None
    return (
        "scan",
        plan.max_groups,
        ex.capacity or table_capacity(plan.max_groups, ex.load_factor),
        ex.morsel_rows,
        ex.update or "scatter",
        expand_agg_specs(plan.aggs),
        saturation == SaturationPolicy.RAISE,
        str(resolve_device(ex.device)),
    )


def read_round_info(info) -> list:
    """A batched round's one blocking read: every lane's info row."""
    return info.tolist()


def consume_batched(executors, chunks) -> None:
    """Consume ``chunks[i]`` into ``executors[i]`` with ONE
    ``scan_ticket_batched`` call for the round.  Every executor comes from
    a plan of the SAME ``batch_signature`` (the scheduler guarantees it).

    Each lane is staged as its solo consume stages it (key column,
    morsels).  With the signature's update ``"scatter"`` (the default)
    the call tickets AND folds every lane's committed morsels into its
    accumulators, as the reference's ``_batched_consume`` does in one
    dispatch: the round makes no update call of its own.  With the other
    updates the call tickets every lane, and each lane then folds its
    tickets through its own update, plane by plane.  A checked round
    reads the lanes' info rows once; a lane that paused or overflowed
    resolves through its operator's own ``poll`` (whose replay of the
    morsels left todo folds them).  A lane already poisoned by an
    overflow is skipped, as its solo consume skips it.  The fast path needs
    the round's chunks to share a row count and carry no ``__mask__``;
    other rounds consume lane by lane.  Each lane's result is its solo
    stream's (on the CPU bit for bit: the plain version runs the lanes in
    order)."""
    assert len(executors) == len(chunks) >= 1
    from repro_torch.kernels import fused_groupby as fk

    ops = [x._op for x in executors]
    if (
        len(ops) == 1
        or len({c.num_rows for c in chunks}) != 1
        or any("__mask__" in c.columns for c in chunks)
    ):
        for x, chunk in zip(executors, chunks):
            x.consume(chunk)
        return
    live = [(op, chunk) for op, chunk in zip(ops, chunks) if not op.poisoned]
    if not live:
        return
    ops = [op for op, _ in live]
    staged = [op.scan_morsels(chunk) for op, chunk in live]
    npm, dev = staged[0][0].shape[0], staged[0][0].device
    todo = torch.ones((len(ops), npm), dtype=torch.int32, device=dev)
    bounds = [op._table.max_groups for op in ops]
    rooms = [op.room() for op in ops]
    checked = ops[0].check_overflow
    room = dict(checked=checked, thresholds=[r[0] for r in rooms],
                bound_slacks=[r[1] for r in rooms])
    tables, keys = [op._table for op in ops], [km for km, _ in staged]
    if ops[0].update == "scatter":  # ticket and fold in the one call
        _, info = fk.scan_ticket_batched(
            tables, keys, todo, states=[op._state for op in ops],
            values=[vm for _, vm in staged], specs=ops[0]._state.specs, **room)
    else:
        tickets, info = fk.scan_ticket_batched(tables, keys, todo, **room)
        for i, (op, (_, vm)) in enumerate(zip(ops, staged)):
            op.update_planes(tickets[i], vm)
    if not checked:
        return
    rows = read_round_info(info)  # the round's one blocking read
    for i, (op, (km, vm)) in enumerate(zip(ops, staged)):
        if rows[i][fk.INFO_HALTED] or rows[i][fk.INFO_COUNT] > bounds[i]:
            op.poll([km, vm, todo[i], info[i:i + 1], bounds[i]])


# ---------------------------------------------------------------------------
# concurrent with sort ticketing (one-shot: chunks buffer)


class _BufferedExecutor(_ExecutorBase):
    """Chunk-buffering consume for a ONE-SHOT strategy: the pipeline is a
    breaker over the full input, so chunks accumulate (on the executor's
    device) and the pipeline runs at ``finalize``.  Tracks its buffer
    high-water marks."""

    def __init__(self, plan: GroupByPlan, device: torch.device):
        self._plan = plan
        self._device = device
        self._keys, self._vals, self._rows = [], [], 0
        self.peak_buffered_chunks = 0
        self.peak_retained_bytes = 0

    def consume(self, chunk: Table) -> None:
        keys, vals = _chunk_keys_values(self._plan, chunk, self._device)
        self._rows += int(keys.shape[0])
        self._keys.append(keys)
        self._vals.append(vals)
        self.peak_buffered_chunks = max(self.peak_buffered_chunks, len(self._keys))
        self.peak_retained_bytes += _nbytes(keys) + sum(_nbytes(v) for v in vals.values())

    def _gathered(self):
        if not self._keys:
            raise ValueError("GroupByPlan executed over zero chunks")
        keys = torch.cat(self._keys)
        vals = {c: torch.cat([v[c] for v in self._vals])
                for c in value_columns(self._plan.aggs)}
        return keys, vals


class _SortExecutor(_BufferedExecutor):
    """Strategy ``concurrent`` with sort-based ticketing.  Tickets are
    global sort ranks, so sorting is a genuine pipeline breaker: chunks
    buffer and ``finalize`` runs ``tk.sort_ticketing`` over the whole
    stream, then the chosen update (``_update_fn_of``).  RAISE raises when
    the issued count passes the bound; GROW widens the bound to it.
    ``finalize`` is a read: consume may go on after it."""

    strategy_label = "sort"

    def finalize(self) -> Table:
        p = self._plan
        keys, vals = self._gathered()
        max_groups = p.max_groups
        tickets, kbt, count = tk.sort_ticketing(keys)
        if p.saturation != SaturationPolicy.UNCHECKED:
            issued = int(count)
            if issued > max_groups:
                if p.saturation == SaturationPolicy.RAISE:
                    raise _overflow_error(issued, max_groups)
                max_groups = _next_bound(max_groups, self._rows, issued=issued)
        state = up.init_agg_state(expand_agg_specs(p.aggs), max_groups, device=self._device)
        state = up.update_agg_state(state, tickets, vals, _update_fn_of(p.execution))
        return build_result_table(p.aggs, state.get, kbt, count, max_groups)


# ---------------------------------------------------------------------------
# concurrent with direct ticketing (streams natively)


class _DirectExecutor(_ExecutorBase):
    """Strategy ``concurrent`` with perfect-hash (direct) ticketing: ticket
    == key, so tickets are stable across chunks and under domain growth;
    each chunk folds straight into the carried ``AggState`` (in place) and
    no chunk is retained.

    RAISE / UNCHECKED consume with no host sync: out-of-domain rows and
    tickets past the bound accumulate in device-side sticky flags, read
    once at finalize by RAISE.  GROW reads both per chunk BEFORE updating:
    an out-of-range chunk widens the domain to cover its largest key
    (rows-bounded, as every other grow), pads the accumulators and
    re-tickets the chunk."""

    strategy_label = "direct"

    def __init__(self, plan: GroupByPlan, device: torch.device):
        if not plan.raw_keys:
            # hash-combined keys leave the bounded domain: every row would miss
            raise ValueError(
                "ticketing='direct' requires raw_keys=True (a single "
                "bounded-domain uint32 key column)"
            )
        self._plan = plan
        self._device = device
        ex = plan.execution
        self._domain = ex.key_domain or plan.max_groups
        self._bound = plan.max_groups
        self._update_fn = _update_fn_of(ex)
        self._state = None
        self._rows = 0
        self._dropped = torch.zeros((), dtype=torch.bool, device=device)  # sticky
        self._max_ticket = torch.full((), -1, dtype=torch.int32, device=device)

    def consume(self, chunk: Table) -> None:
        p = self._plan
        keys, vals = _chunk_keys_values(p, chunk, self._device)
        self._rows += int(keys.shape[0])
        if self._state is None:
            self._state = up.init_agg_state(expand_agg_specs(p.aggs), self._bound,
                                            device=self._device)
        tickets, _, _ = tk.direct_ticketing(keys, self._domain)
        valid = keys != EMPTY_I32
        top = tickets.max() if tickets.numel() else tickets.new_full((), -1)
        if p.saturation == SaturationPolicy.GROW:
            dropped, used = torch.stack([
                ((tickets < 0) & valid).any().to(torch.int64),
                top.to(torch.int64) + 1,
            ]).tolist()
            if dropped or used > self._bound:
                # the domain must cover the largest observed key VALUE
                u = keys.to(torch.int64) & 0xFFFFFFFF
                kmax = int(torch.where(valid, u, torch.zeros_like(u)).max())
                limit = max(4 * self._rows, 65536)
                if kmax + 1 > limit:
                    raise GroupByOverflowError(
                        f"direct-ticketing overflow: observed key {kmax} "
                        f"needs domain {kmax + 1}, past the rows-bounded "
                        f"growth limit {limit} — the key space is too "
                        "sparse for perfect-hash ticketing; use "
                        "ticketing='hash' instead."
                    )
                self._domain = max(kmax + 1, self._domain)
                # the bound never shrinks: earlier chunks committed slots
                self._bound = max(self._domain, self._bound, 64)
                self._state = up.grow_agg_state(self._state, self._bound)
                tickets, _, _ = tk.direct_ticketing(keys, self._domain)
        else:
            self._dropped |= ((tickets < 0) & valid).any()
            self._max_ticket = torch.maximum(self._max_ticket, top)
        self._state = up.update_agg_state(self._state, tickets, vals, self._update_fn)

    def finalize(self) -> Table:
        p = self._plan
        if self._state is None:
            raise ValueError("GroupByPlan executed over zero chunks")
        domain, max_groups = self._domain, self._bound
        _, kbt, count = tk.direct_ticketing(
            torch.zeros((0,), dtype=torch.int32, device=self._device), domain
        )
        if p.saturation == SaturationPolicy.RAISE:
            dropped, used = bool(self._dropped), int(self._max_ticket) + 1
            if dropped or used > max_groups:
                raise GroupByOverflowError(
                    "direct-ticketing overflow: keys outside "
                    f"domain={domain} or past max_groups={max_groups} "
                    "would be dropped. Use SaturationPolicy.GROW or "
                    "declare a larger key_domain/max_groups."
                )
        if p.saturation != SaturationPolicy.UNCHECKED:
            # checked reads promise count ≤ materialized rows
            count = torch.clamp(count, max=max_groups)
        return build_result_table(p.aggs, self._state.get, kbt, count, max_groups)

    def device_table_bytes(self) -> int:
        if self._state is None:
            return 0
        return sum(_nbytes(a) for a in self._state.accs)


# ---------------------------------------------------------------------------
# hybrid: heavy-hitter registers + the scan route's tail (streams natively)


def _heavy_tensor(heavy, device: torch.device) -> torch.Tensor:
    """Heavy keys (uint32 values or int32 bit patterns, EMPTY-padded) → an
    int32 bit-pattern tensor on ``device``; no live key may repeat (the
    register fold gives a row one register).  An empty set becomes one
    EMPTY register, as in the reference."""
    t = heavy if isinstance(heavy, torch.Tensor) else torch.as_tensor(
        np.asarray(heavy).astype(np.int64))
    t = to_i32_bits(t.reshape(-1)).to(device)
    if t.shape[0] == 0:
        return torch.full((1,), EMPTY_I32, dtype=torch.int32, device=device)
    live = t[t != EMPTY_I32]
    if torch.unique(live).numel() != live.numel():
        raise ValueError("hybrid heavy_keys repeat a key: each live key takes one register")
    return t


class _HybridExecutor(_ExecutorBase):
    """Strategy ``hybrid``: rows of a small heavy-hitter candidate set fold
    into dense per-key registers (``kernels.hybrid_registers``: the
    hand-written kernel on a card, its plain version on the CPU), which
    also strips them from the chunk; the tail flows through the scan
    route's :class:`GroupByOperator`.  Streams natively: ``grow`` rides the
    tail operator's in-stream bound growth and no chunk is retained.  The
    heavy keys own the tail table's first tickets, and the registers merge
    into the tail accumulators at finalize (a read: consume may go on)."""

    strategy_label = "hybrid"

    def __init__(self, plan: GroupByPlan, device: torch.device):
        self._plan = plan
        self._device = device
        self._specs = expand_agg_specs(plan.aggs)
        self._kinds = tuple(k for _, k in self._specs)
        self._vcols = value_columns(plan.aggs)
        hk = plan.execution.heavy_keys
        self._heavy = None if hk is None else _heavy_tensor(hk, device)
        self._regs = None   # (S, R) float32, one row per accumulator spec
        self._op = None

    def _init_regs(self) -> None:
        r = self._heavy.shape[0]
        self._regs = torch.stack([up.init_acc(r, k, device=self._device)
                                  for k in self._kinds])

    @classmethod
    def adopt(cls, plan: GroupByPlan, op: GroupByOperator) -> "_HybridExecutor":
        """Mid-stream escalation: adopt a live scan-route operator (table,
        accumulators, grown bound; in-flight tokens stay valid) as the tail
        pipeline.  The heavy keys (``plan.execution.heavy_keys``) get
        tickets now (idempotent for keys already seen); the registers start
        at identity, because every pre-switch heavy row is already counted
        in the tail accumulators.  All of it is ordered on the card's one
        stream after the launches already in flight."""
        self = cls(plan, op._device)
        if self._heavy is None:
            raise ValueError("adopt() requires pinned heavy_keys")
        # the tail now arrives as the combined key column: the operator
        # switches to the raw ``__key__`` convention (same key space)
        op.key_columns = ["__key__"]
        op.raw_keys = True
        if _instrument(plan) and not op.collect_events:
            # pre-switch counts are lost; post-switch counts are exact
            op.collect_events = True
            op._events = obs_metrics.zero_event_vector(op._device)
        if op.grow_bound:
            op._grow(int(self._heavy.shape[0]))  # headroom for the inserts
        _, op._table = tk.get_or_insert(op._table, self._heavy)
        self._op = op
        self._init_regs()
        return self

    def _make_op(self, max_groups: int) -> GroupByOperator:
        p, ex = self._plan, self._plan.execution
        op = GroupByOperator(
            key_columns=["__key__"], aggs=list(p.aggs), max_groups=max_groups,
            morsel_rows=ex.morsel_rows, update=ex.update or "scatter",
            use_kernel=ex.kernel == "scan_body", load_factor=ex.load_factor,
            pipeline=ex.pipeline, capacity=ex.capacity, raw_keys=True,
            check_overflow=p.saturation != SaturationPolicy.UNCHECKED,
            grow_bound=p.saturation == SaturationPolicy.GROW,
            collect_events=_instrument(p), device=str(self._device),
        )
        # heavy keys own the FIRST tickets: a key whose every row the
        # registers absorb still gets its group
        _, op._table = tk.get_or_insert(op._table, self._heavy)
        return op

    def consume(self, chunk: Table) -> None:
        self.poll(self.consume_async(chunk))

    def consume_async(self, chunk: Table):
        from repro_torch.core.hybrid import detect_heavy_hitters
        from repro_torch.kernels.hybrid_registers import hybrid_registers

        keys, vals = _chunk_keys_values(self._plan, chunk, self._device)
        if self._heavy is None:
            self._heavy = _heavy_tensor(
                detect_heavy_hitters(keys, self._plan.execution.num_registers), self._device)
        if self._op is None:
            self._init_regs()
            self._op = self._make_op(self._plan.max_groups)
        planes = [None if kind == "count" else vals[col] for col, kind in self._specs]
        tail = hybrid_registers(keys, self._heavy, planes, self._regs, kinds=self._kinds)
        tail_chunk = Table({"__key__": tail, **{c: vals[c] for c in self._vcols}})
        return self._op.consume_async(tail_chunk)

    def poll(self, token) -> None:
        if token is not None:
            self._op.poll(token)

    def _merged_state(self) -> up.AggState:
        """Copies of the tail accumulators with the registers folded into
        their tickets' slots: a pure read of the live state, so
        ``finalize`` stays idempotent."""
        op = self._op
        heavy_tickets = tk.lookup(op._table, self._heavy)  # -1 for padding
        accs = []
        for s, ((_, kind), acc) in enumerate(zip(op._state.specs, op._state.accs)):
            merge_kind = "sum" if kind in ("sum", "count") else kind
            accs.append(up.scatter_update(acc.clone(), heavy_tickets, self._regs[s],
                                          kind=merge_kind))
        return up.AggState(op._state.specs, tuple(accs))

    def finalize(self) -> Table:
        if self._op is None:
            raise ValueError("GroupByPlan executed over zero chunks")
        op = self._op
        tail_state = op._state
        op._state = self._merged_state()
        try:
            return op.finalize()
        finally:
            # registers stay separate: consume may continue after a read
            op._state = tail_state

    def device_table_bytes(self) -> int:
        if self._op is None:
            return 0
        return (resize.table_nbytes(self._op._table)
                + sum(_nbytes(a) for a in self._op._state.accs) + _nbytes(self._regs))

    def event_counts(self):
        if self._op is None or not self._op.collect_events:
            return None
        # tail-pipeline counts only: register-absorbed rows never enter
        # the scan, so ``rows`` reads as "tail rows"
        return self._op.event_counts()


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
            # a partial may hold more slots than keys (partitioned: fewer
            # exchanged rows than the bound); the keys' slots lead
            self._accs[spec] = up.scatter_update(
                self._accs[spec], tickets, acc[:kbt.shape[0]], kind=_MERGE_KIND[spec[1]]
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


class _PartitionedExecutor(_IncrementalMergeExecutor):
    """Strategy ``partitioned``: the Leis-style pre-aggregation → exchange
    → partition-wise pipeline (``core/partitioned.py``; the ``preagg``
    kernel on a card) runs per chunk (each chunk IS a morsel batch through
    local pre-aggregation) and the chunk's partial groups merge into the
    carried table.  One non-mean aggregate per plan (the pre-agg table
    carries a single partial).  Each chunk is padded with EMPTY rows to a
    multiple of ``num_workers``.  GROW reruns the CHUNK with the issued
    count as its bound (``_next_bound``; ``reruns`` counts them) and
    raises when the bound already covers the rows and the count."""

    strategy_label = "partitioned"

    def __init__(self, plan: GroupByPlan, device: torch.device):
        super().__init__(plan, device)
        self._agg = _single_agg(plan, "partitioned")
        self.reruns = 0

    def _chunk_partial(self, keys, vals):
        from repro_torch.core.partitioned import _partitioned_impl

        p, ex = self._plan, self._plan.execution
        v = (vals[self._agg.column] if self._agg.column
             else torch.ones(keys.shape, dtype=torch.float32, device=self._device))
        rem = (-int(keys.shape[0])) % ex.num_workers
        if rem:
            keys = torch.cat([keys, keys.new_full((rem,), EMPTY_I32)])
            v = torch.cat([v, v.new_zeros((rem,))])
        bound = self._chunk_bound
        while True:
            res = _partitioned_impl(
                keys, v, kind=self._agg.kind, max_groups=bound,
                num_workers=ex.num_workers, preagg_capacity=ex.preagg_capacity,
                morsel_size=ex.preagg_morsel,
            )
            ovf = res.num_groups > bound
            if p.saturation != SaturationPolicy.GROW:
                break
            issued = int(res.num_groups)
            if issued <= bound:
                break
            if bound >= max(self._rows, issued):
                raise _overflow_error(issued, bound)
            bound = _next_bound(bound, self._rows, issued=issued)
            self.reruns += 1
        self._chunk_bound = bound
        return res.keys, {self._specs[0]: res.values}, res.num_groups, ovf


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
