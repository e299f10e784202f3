"""Adaptive strategy selection (paper §3.2 Discussion + Table 1).

Port of ``repro.core.adaptive``.  The paper recommends choosing the update
method per query from optimizer statistics (cardinality, skew), with
thread-local as the safe default; this is that policy, with the
reference's strategy names, plus a cheap on-sample estimator for when the
optimizer has no statistics.

Decision table (the reference's adaptation of paper Table 1):

  cardinality      skew        → ticketing    update        distributed merge
  ---------------------------------------------------------------------------
  tiny (≤ 4k)      any         → hash         onehot        dense psum
  low–high         any         → hash         scatter       dense psum
  unique-ish       low         → sort         sort_segment  all_to_all (partitioned)
  unique-ish       heavy       → hash         scatter       dense psum (skew-immune)
  bounded domain   any         → direct       scatter       dense psum

The statistics are host-side: a sample leaves the device once
(``.cpu().numpy()``).  Keys are int32 bit patterns in the port and uint32
values in the reference; every sample is viewed as ``np.uint32`` before
``np.unique``, so the sort order (and with it the Misra–Gries admission
order and the heavy-hitter tie-break) is the reference's, also for keys of
2^31 and up.

What picks the kernel route on a CUDA device is not here: see
``engine.executors.cuda_route``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hashing import EMPTY_KEY, table_capacity


@dataclass(frozen=True)
class WorkloadStats:
    n_rows: int
    est_groups: int           # cardinality estimate (optimizer or sample)
    est_top_freq: float       # estimated frequency of the heaviest key (0..1)
    key_domain: int | None = None  # known bounded domain, if any


@dataclass(frozen=True)
class Plan:
    ticketing: str   # hash | sort | direct
    update: str      # scatter | onehot | sort_segment | serialized
    distributed: str  # dense_psum | all_to_all
    capacity: int    # ticket table capacity (pow2)
    kernel: str | None = None  # fused | None (planner's ExecutionPolicy.kernel pick)


def fused_table_bytes(est_groups: int, num_accumulators: int = 1,
                      load_factor: float = 0.5) -> int:
    """Device bytes of ONE fused-kernel program's persistent state at a
    group bound: the open-addressed table (keys + tickets, int32 each at
    ``capacity = est_groups / load_factor`` rounded to pow2), the
    ticket→key map, and one float32 accumulator row per ``AggSpec``
    accumulator (mean counts twice: sum + count)."""
    cap = table_capacity(max(est_groups, 1), load_factor)
    return 8 * cap + 4 * est_groups + 4 * num_accumulators * est_groups


def kernel_table_budget(device=None) -> int:
    """Bytes the planner lets a fused table claim: 0 on every device the
    port runs on.  The reference claims a quarter of VMEM on a TPU and 0
    elsewhere; a CUDA card has no VMEM-sized residency cliff (the fused
    kernel's table lives in device memory on every route), so the route on
    a card is set by measured walls instead (``engine.executors
    .cuda_route``).  An explicit ``choose_plan(vmem_budget=...)`` still
    applies the reference's fit check."""
    return 0


def choose_plan(stats: WorkloadStats, *, num_accumulators: int = 1,
                vmem_budget: int | None = None) -> Plan:
    """The reference's Table 1 policy, field for field."""
    unique_frac = stats.est_groups / max(stats.n_rows, 1)
    heavy = stats.est_top_freq >= 0.25
    cap = table_capacity(stats.est_groups)
    budget = kernel_table_budget() if vmem_budget is None else vmem_budget
    # bound the fused fit check at the 2× headroom the resolver binds
    fused = (
        "fused"
        if fused_table_bytes(2 * stats.est_groups, num_accumulators) <= budget
        else None
    )
    if stats.key_domain is not None and stats.key_domain <= 2 * stats.est_groups:
        # direct ticketing: ticket == key, so capacity only needs the domain
        return Plan("direct", "scatter", "dense_psum",
                    table_capacity(stats.key_domain, load_factor=1.0))
    if stats.est_groups <= 4096:
        return Plan("hash", "onehot", "dense_psum", cap, fused)
    if unique_frac >= 0.8 and not heavy:
        return Plan("sort", "sort_segment", "all_to_all", cap)
    return Plan("hash", "scatter", "dense_psum", cap, fused)


def sample_u32(keys: torch.Tensor, sample: int) -> tuple[int, np.ndarray]:
    """``(rows, live prefix sample)``: the first ``sample`` keys of a key
    column on the host as uint32 values, EMPTY rows dropped."""
    flat = torch.as_tensor(keys).reshape(-1)
    s = min(sample, flat.shape[0])
    ks = (flat[:s].to(torch.int64).cpu().numpy() & 0xFFFFFFFF).astype(np.uint32)
    return int(flat.shape[0]), ks[ks != np.uint32(EMPTY_KEY)]


class RunningStats:
    """Mergeable workload statistics carried ACROSS stream chunks (see
    ``repro.core.adaptive.RunningStats``): a Misra–Gries counter set of
    ``num_counters`` slots for heavy-hitter mass, and a bounded union of
    sampled distinct keys for the cardinality estimate.  Keys are kept as
    uint32 values, as in the reference."""

    def __init__(self, num_counters: int = 16, sample: int = 4096,
                 distinct_cap: int = 1 << 16, domain: int | None = None):
        self.num_counters = num_counters
        self.sample = sample
        self.distinct_cap = distinct_cap
        self.domain = domain
        self.n_rows = 0
        self.sampled = 0
        self._counters: dict[int, int] = {}
        self._distinct: set[int] = set()
        self._distinct_saturated = False

    def update(self, keys: torch.Tensor) -> WorkloadStats:
        """Fold one chunk's prefix sample into the sketch; returns the
        refreshed cumulative :class:`WorkloadStats`."""
        rows, ks = sample_u32(keys, self.sample)
        self.n_rows += rows
        self.sampled += int(ks.size)
        if ks.size:
            uniq, counts = np.unique(ks, return_counts=True)
            for k, c in zip(uniq.tolist(), counts.tolist()):
                if k in self._counters:
                    self._counters[k] += c
                elif len(self._counters) < self.num_counters:
                    self._counters[k] = c
                else:
                    # weighted Misra–Gries decrement round: pay the smaller
                    # of the newcomer's weight and the lightest counter,
                    # evict the emptied counters, admit the newcomer with
                    # its residual weight
                    d = min(c, min(self._counters.values()))
                    self._counters = {
                        key: v - d for key, v in self._counters.items() if v > d
                    }
                    if c > d and len(self._counters) < self.num_counters:
                        self._counters[k] = c - d
            if not self._distinct_saturated:
                self._distinct.update(uniq.tolist())
                if len(self._distinct) >= self.distinct_cap:
                    self._distinct_saturated = True
        return self.stats

    @property
    def heavy_keys(self):
        """Current heavy-hitter candidates (uint32 values), heaviest first."""
        return sorted(self._counters, key=self._counters.get, reverse=True)

    def heavy_array(self, limit: int | None = None) -> np.ndarray:
        """Heavy-hitter candidates as a uint32 numpy array, heaviest first."""
        keys = self.heavy_keys if limit is None else self.heavy_keys[:limit]
        return np.asarray(keys, dtype=np.uint32) if keys else np.zeros((0,), np.uint32)

    @property
    def stats(self) -> WorkloadStats:
        u = len(self._distinct)
        if self.sampled == 0:
            return WorkloadStats(self.n_rows, 1, 0.0, self.domain)
        top = max(self._counters.values(), default=0) / self.sampled
        if self._distinct_saturated or u > 0.5 * self.sampled:
            est = int(min(max(u * self.n_rows / self.sampled, u), self.n_rows))
        else:
            est = u
        return WorkloadStats(self.n_rows, max(est, 1), top, self.domain)


def sample_stats(keys: torch.Tensor, sample: int = 4096,
                 domain: int | None = None) -> WorkloadStats:
    """Estimate cardinality and skew from a prefix sample with the
    birthday-style estimator n̂ = u · n / s on the sample's unique count u
    (anchored at u when the sample repeats keys)."""
    rows, valid = sample_u32(keys, sample)
    if valid.size == 0:
        return WorkloadStats(rows, 1, 0.0, domain)
    uniq, counts = np.unique(valid, return_counts=True)
    u = int(uniq.size)
    top = float(counts.max()) / float(valid.size)
    if u > 0.5 * valid.size:
        est = int(min(u * rows / valid.size, rows))
    else:
        est = u
    est = min(max(est, u), rows)  # never below u, never above n
    return WorkloadStats(rows, est, top, domain)
