"""Out-of-core GROUP BY: the spill-to-host subsystem (``saturation="spill"``).

Port of ``repro.engine.spill``.  ``max_groups`` becomes a **device
residency budget** rather than a result-cardinality bound.  Hot groups stay
in the device ticket table (the scan route's :class:`GroupByOperator`),
classified with the Misra–Gries sketch of
:class:`repro_torch.core.adaptive.RunningStats`; rows whose key hashes to a
cold partition go to host partitions.  ``finalize`` runs a second pass:
each spilled partition streams back through the same scan route and is
unioned with the device table, so results are exact however well the
hot/cold classification guessed.

Residency invariant: admission control in
:meth:`SpillExecutor.consume_async` keeps the hot table's group count at
or below the budget, and ``hashing.table_capacity`` gives its probe table
≥ 2× budget slots, so its load-factor pause never fires and the device
table NEVER migrates.  The second pass sizes each partition operator to
the partition's exact cardinality (known on the host), so peak device table
bytes stay ≤ hot table + one partition table — ≤ 2× the residency
footprint whenever a partition's cardinality fits the budget.

Host side, as in the reference: per chunk, ONE blocking read brings the
keys and the hot-table hits (``tk.lookup``) to the host, where routing,
admission and partitioning run in numpy on the keys' uint32 values.  On a
card the cold value columns are gathered on the device in partition order
and copied with ``non_blocking=True`` into pinned host buffers on a side
CUDA stream, after an event on the main stream, so the copy overlaps the
hot operator's launches; ``_flush_staged`` (the next poll, stats or
finalize) waits on the copy's event, and the gathered device tensors stay
referenced until it has.  The host partitions are those pinned CPU
tensors.

Correctness does not depend on the classifier: a key demoted after being
admitted (or admitted after first spilling) has rows on both sides, and
``finalize`` folds the partition partials into copies of the hot
accumulators by ticket (``mean`` is sum + count).  Partitions are
hash-disjoint, so no cross-partition dedup is needed.  ``finalize``
changes neither the operator nor the partitions: a snapshot can be taken
mid-spill, twice, and consumption continues afterwards.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import adaptive, resize
from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32, EMPTY_KEY
from repro_torch.data.pipeline import BlockSource
from repro_torch.engine.columns import Table
from repro_torch.engine.executors import (
    _MERGE_KIND,
    _chunk_keys_values,
    _ExecutorBase,
    _instrument,
    _nbytes,
)
from repro_torch.engine.groupby import GroupByOperator, build_result_table, expand_agg_specs
from repro_torch.engine.plan_api import GroupByPlan, value_columns
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_EMPTY32 = np.uint32(EMPTY_KEY)


def partition_of(keys: np.ndarray, num_partitions: int) -> np.ndarray:
    """Cold-partition id per key: murmur3 fmix32 of the key's uint32 value
    mod the partition count, in numpy so that routing runs on the host on
    already-fetched keys (int32 bit patterns are viewed as uint32)."""
    keys = np.asarray(keys)
    if keys.dtype == np.int32:
        keys = keys.view(np.uint32)
    x = keys.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return (x % np.uint32(num_partitions)).astype(np.int64)


class SpillManager:
    """Host-resident cold partitions with spill / readmission accounting.

    Each :meth:`spill` call appends one chunk's cold rows, sorted by
    partition, as one contiguous block per touched partition: CPU tensors
    (``__key__`` int32 bit patterns and one float32 column per value
    column), views of the buffers the caller filled (pinned on a card).
    A partition reads back as a :class:`BlockSource`."""

    def __init__(self, num_partitions: int, value_cols):
        self.num_partitions = int(num_partitions)
        self._value_cols = tuple(value_cols)
        self._blocks: list[list[dict]] = [[] for _ in range(self.num_partitions)]
        self.partition_rows = [0] * self.num_partitions
        self.partition_bytes = [0] * self.num_partitions
        self.spilled_rows = 0
        self.spilled_bytes = 0
        self.spill_events = 0
        self.readmitted_rows = 0

    def spill(self, keys: torch.Tensor, pids: np.ndarray, vals: dict) -> None:
        """Append one chunk's cold rows: ``keys`` (n,) int32 CPU tensor,
        ``pids`` (n,) partition ids in non-decreasing order, ``vals``
        column → (n,) float32 CPU tensor, all in the same order."""
        uniq, starts = np.unique(pids, return_index=True)
        bounds = starts.tolist() + [len(pids)]
        for pid, lo, hi in zip(uniq.tolist(), bounds[:-1], bounds[1:]):
            block = {"__key__": keys[lo:hi]}
            for c in self._value_cols:
                block[c] = vals[c][lo:hi]
            nbytes = sum(_nbytes(a) for a in block.values())
            self._blocks[pid].append(block)
            self.partition_rows[pid] += hi - lo
            self.partition_bytes[pid] += nbytes
            self.spilled_rows += hi - lo
            self.spilled_bytes += nbytes
        self.spill_events += 1

    def partitions(self) -> list[int]:
        """Non-empty partition ids (the second pass visits these)."""
        return [p for p in range(self.num_partitions) if self.partition_rows[p]]

    def partition_keys(self, pid: int) -> np.ndarray:
        """Every spilled key of one partition as uint32 values (for the
        exact cardinality of its second-pass operator)."""
        blocks = self._blocks[pid]
        if not blocks:
            return np.zeros((0,), np.uint32)
        return np.concatenate([b["__key__"].numpy().view(np.uint32) for b in blocks])

    def readmit(self, pid: int) -> BlockSource:
        """One partition as a chunk source, a block per chunk.  The blocks
        are NOT freed: readmission is a read, so finalize stays
        idempotent."""
        self.readmitted_rows += self.partition_rows[pid]
        return BlockSource(tuple(self._blocks[pid]))

    def stats(self) -> dict:
        return {
            "spilled_rows": self.spilled_rows,
            "spilled_bytes": self.spilled_bytes,
            "spilled_partitions": len(self.partitions()),
            "spill_events": self.spill_events,
            "readmitted_rows": self.readmitted_rows,
            "partition_rows": tuple(self.partition_rows),
            "partition_bytes": tuple(self.partition_bytes),
        }


class SpillExecutor(_ExecutorBase):
    """``saturation="spill"`` on the concurrent hash pipeline (see the
    module docstring).

    Per chunk: canonicalize the keys, fold the sketch, probe the hot table
    (one ``tk.lookup``), read keys and hits to the host once, and route
    there: rows whose key is hot, or newly admitted under the budget, feed
    the hot operator with the other rows masked to EMPTY; the cold rows go
    to the :class:`SpillManager`.  Admission demotes half the resident
    partitions whenever a chunk's new keys would pass the budget, then
    falls back to the heaviest sketch keys that fit, so ``count ≤ budget``
    holds exactly (mirrored on the host).  ``consume_async`` / ``poll``
    delegate the device half to the operator's own tokens."""

    strategy_label = "spill"

    def __init__(self, plan: GroupByPlan, device: torch.device):
        if plan.execution.ticketing != "hash":
            raise ValueError(
                "saturation='spill' requires ticketing='hash' (the hot table "
                "is the probe table the spill router classifies against)"
            )
        p, ex = plan, plan.execution
        self._plan = plan
        self._device = device
        self._budget = int(p.max_groups)
        self._vcols = value_columns(p.aggs)
        self._specs = expand_agg_specs(p.aggs)
        # the hot operator: ≥ 2× budget probe slots and count ≤ budget, so
        # the load-factor pause never fires and the table never migrates
        self._op = self._make_op(self._budget, capacity=ex.capacity,
                                 collect_events=_instrument(plan))
        self._manager = SpillManager(ex.spill_partitions, self._vcols)
        self._sketch = adaptive.RunningStats(domain=ex.key_domain)
        self._resident = np.ones(ex.spill_partitions, bool)
        self._host_count = 0          # exact mirror of the hot table's count
        self._readmission_passes = 0  # partition replays across finalizes
        self._rows = 0
        self._residency_bytes = self._device_bytes(self._op)
        self._peak_device_bytes = self._residency_bytes
        self._pinned = device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(device) if self._pinned else None
        # cold batches whose device→host copy is in flight:
        # (keys, pids, host value buffers, copy-done event, device sources)
        self._staged: list = []

    def _make_op(self, max_groups: int, *, capacity=None, collect_events=False):
        p, ex = self._plan, self._plan.execution
        return GroupByOperator(
            key_columns=["__key__"], aggs=list(p.aggs), max_groups=max_groups,
            morsel_rows=ex.morsel_rows, update=ex.update or "scatter",
            use_kernel=ex.kernel == "scan_body", load_factor=ex.load_factor,
            pipeline=ex.pipeline, capacity=capacity, raw_keys=True,
            check_overflow=True, grow_bound=False,
            collect_events=collect_events, device=str(self._device),
        )

    @staticmethod
    def _device_bytes(op: GroupByOperator) -> int:
        return resize.table_nbytes(op._table) + sum(_nbytes(a) for a in op._state.accs)

    # -- streaming protocol --------------------------------------------------

    def consume(self, chunk: Table) -> None:
        self.poll(self.consume_async(chunk))

    def consume_async(self, chunk: Table):
        keys, vals = _chunk_keys_values(self._plan, chunk, self._device)
        self._rows += int(keys.shape[0])
        hits_dev = tk.lookup(self._op._table, keys)
        # the chunk's one blocking read: keys and hits together
        both = torch.stack([keys, hits_dev]).cpu()
        self._sketch.update(both[0])
        both = both.numpy()
        keys_np = both[0].view(np.uint32)
        hits = both[1] >= 0
        valid = keys_np != _EMPTY32
        pids = partition_of(keys_np, self._manager.num_partitions)
        admit, n_new = self._admit(keys_np, valid, hits, pids)
        self._host_count += n_new
        device_mask = hits | admit
        dkeys = torch.where(torch.from_numpy(device_mask).to(self._device), keys, EMPTY_I32)
        token = self._op.consume_async(
            Table({"__key__": dkeys, **{c: vals[c] for c in self._vcols}})
        )
        cold = valid & ~device_mask
        if cold.any():
            # partition-major order, so each partition's rows land in one
            # contiguous run of the host buffers
            idx = np.flatnonzero(cold)
            idx = idx[np.argsort(pids[idx], kind="stable")]
            self._stage(keys_np[idx], pids[idx], idx, vals)
        return token

    def _stage(self, keys_cold: np.ndarray, pids_cold: np.ndarray, idx: np.ndarray,
               vals: dict) -> None:
        """Gather the cold rows' value columns on the device and START their
        copy to the host (a side stream on a card, behind an event on the
        main stream), so it overlaps the hot operator's launches."""
        idx_dev = torch.from_numpy(idx).to(self._device)
        gathered = {c: vals[c].index_select(0, idx_dev) for c in self._vcols}
        keys_host = torch.from_numpy(keys_cold.view(np.int32))
        if not self._pinned:
            self._staged.append((keys_host, pids_cold, gathered, None, None))
            return
        keys_host = keys_host.pin_memory()
        host = {c: torch.empty(len(idx), dtype=torch.float32, pin_memory=True)
                for c in self._vcols}
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._device))
        done = torch.cuda.Event()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            for c in self._vcols:
                host[c].copy_(gathered[c], non_blocking=True)
            done.record(self._copy_stream)
        self._staged.append((keys_host, pids_cold, host, done, gathered))

    def poll(self, token) -> None:
        self._op.poll(token)
        self._flush_staged()

    def _flush_staged(self) -> None:
        """Collect every staged cold batch into the host partitions: wait
        on each copy's event (then its device sources may go).  Runs at the
        chunk's poll and before finalize / stats; the ``spill_flush_wait``
        span is the wait the overlap did NOT hide."""
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        with obs_trace.span("spill_flush_wait", batches=len(staged)):
            for keys_host, pids, host, done, _sources in staged:
                if done is not None:
                    done.synchronize()
                self._manager.spill(keys_host, pids, host)

    def _admit(self, keys_np, valid, hits, pids):
        """Choose this chunk's NEW device admissions under the budget.

        Candidates are missing keys that are sketch-heavy or hash to a
        still-resident partition.  While the chunk's distinct candidates
        would pass the budget, demote half the resident partitions (for
        good); once none remain, admit only the heaviest-first sketch prefix
        that fits.  Returns the admission mask and the EXACT number of new
        groups (the candidates all missed the probe, so distinct == new
        tickets).  ``keys_np`` holds uint32 values."""
        budget, count = self._budget, self._host_count
        heavy = self._sketch.heavy_array()
        miss = valid & ~hits
        while True:
            is_heavy = np.isin(keys_np, heavy) if heavy.size else np.zeros_like(valid)
            if self._resident.any():
                cand = miss & (is_heavy | self._resident[pids])
            else:
                cand = miss & is_heavy
            n_new = int(np.unique(keys_np[cand]).size)
            if count + n_new <= budget:
                return cand, n_new
            if self._resident.any():
                res = np.flatnonzero(self._resident)
                self._resident[res[len(res) // 2:]] = False
            else:
                heavy = heavy[: max(budget - count, 0)]

    # -- finalize: second-pass streamed merge --------------------------------

    def _partition_op(self, pid: int) -> GroupByOperator:
        """A fresh operator for one partition's second pass, bound to the
        partition's EXACT cardinality (from its spilled keys on the host):
        it can neither overflow nor pause, and its table is no larger than
        the hot table whenever that cardinality is within the budget."""
        card = int(np.unique(self._manager.partition_keys(pid)).size)
        return self._make_op(max(card, 1))

    def finalize(self) -> Table:
        self._flush_staged()
        op = self._op
        parts = self._manager.partitions()
        if not parts:
            # nothing spilled yet: identical to the plain concurrent scan
            return op.finalize()
        count_hot = int(op._table.count)
        if count_hot != self._host_count:
            raise RuntimeError(f"hot table holds {count_hot} groups, the host mirror "
                               f"{self._host_count}")
        # copies of the hot accumulators: the fold below must not disturb
        # the live operator (finalize is a pure read)
        merged = {spec: acc.clone() for spec, acc in zip(op._state.specs, op._state.accs)}
        union_keys = [op._table.key_by_ticket[:count_hot]]
        fresh_accs: dict = {spec: [] for spec in self._specs}
        peak = self._residency_bytes
        for pid in parts:
            with obs_trace.span("spill_partition_replay", partition=pid,
                                rows=self._manager.partition_rows[pid]):
                pop = self._partition_op(pid)
                for chunk in self._manager.readmit(pid).chunks():
                    pop.consume(chunk)
                self._readmission_passes += 1
            peak = max(peak, self._residency_bytes + self._device_bytes(pop))
            kbt_p = pop._table.key_by_ticket
            t_hot = tk.lookup(op._table, kbt_p)
            # keys demoted after admission fold into their hot ticket (-1:
            # absent, parked); the rest are groups the device never held
            fresh = (kbt_p != EMPTY_I32) & (t_hot < 0)
            for spec in self._specs:
                acc_p = pop._state.get(*spec)
                merged[spec] = up.scatter_update(merged[spec], t_hot, acc_p,
                                                 kind=_MERGE_KIND[spec[1]])
                fresh_accs[spec].append(acc_p[fresh])
            union_keys.append(kbt_p[fresh])
        self._peak_device_bytes = max(self._peak_device_bytes, peak)
        keys_all = torch.cat(union_keys)
        total = int(keys_all.shape[0])
        accs_all = {spec: torch.cat([merged[spec][:count_hot]] + fresh_accs[spec])
                    for spec in self._specs}
        return build_result_table(
            self._plan.aggs, lambda c, k: accs_all[(c, k)], keys_all, total, total,
        )

    # -- telemetry -----------------------------------------------------------

    def memory_stats(self) -> dict:
        self._flush_staged()  # the counters cover every consumed chunk
        s = super().memory_stats()
        s.update(self._manager.stats())
        s["peak_retained_bytes"] = max(s["peak_retained_bytes"], self._manager.spilled_bytes)
        s["residency_budget"] = self._budget
        s["residency_bytes"] = self._residency_bytes
        s["peak_device_table_bytes"] = self._peak_device_bytes
        s["device_groups"] = self._host_count
        s["resident_partitions"] = int(self._resident.sum())
        return s

    def device_table_bytes(self) -> int:
        return self._device_bytes(self._op)

    def event_counts(self):
        # hot-table counters only (partition replays are transient); the
        # residency invariant shows here: migrations stays 0
        if not self._op.collect_events:
            return None
        return self._op.event_counts()

    def stats(self) -> dict:
        out = super().stats()
        spill = dict(self._manager.stats())
        spill["readmission_passes"] = self._readmission_passes
        spill["residency_budget"] = self._budget
        spill["residency_bytes"] = self._residency_bytes
        spill["peak_device_table_bytes"] = self._peak_device_bytes
        spill["resident_partitions"] = int(self._resident.sum())
        out["spill"] = spill
        if obs_metrics.enabled():
            pub = getattr(self, "_spill_publisher", None)
            if pub is None:
                pub = obs_metrics.EventPublisher(strategy=self.strategy_label)
                self._spill_publisher = pub
            pub.publish({
                "spill.spilled_rows": self._manager.spilled_rows,
                "spill.spilled_bytes": self._manager.spilled_bytes,
                "spill.spill_events": self._manager.spill_events,
                "spill.readmitted_rows": self._manager.readmitted_rows,
                "spill.readmission_passes": self._readmission_passes,
            })
            obs_metrics.gauge(
                "spill.resident_partitions", strategy=self.strategy_label
            ).set(int(self._resident.sum()))
        return out


__all__ = ["SpillExecutor", "SpillManager", "partition_of"]
