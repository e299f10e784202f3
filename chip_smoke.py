#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero, printing no result, without them.
Four phases, each of which fails the run:

1. build — compile the port's three CUDA sources (``fused_groupby``,
   ``ticket_hash``, ``segment_agg``), one ``nvcc`` each, all started
   together, and print the commands, the seconds and ``-Xptxas -v``.
2. kernel vs plain — each kernel and its plain version on the same CUDA
   tensors.  ``fused_consume`` (its grid printed: CTAs, CTAs per
   program): 2^20 rows of uniform, zipf and heavy-hitter keys at P = 1
   and 4 under an exact bound; a forced pause under a GROW bound (the
   committed morsels' rows counted once, no ticket past the bound) and the
   replay of each version's todo morsels after ``grow_fused_state``; an
   unchecked, saturated table (1024 slots, 4096 distinct keys), which
   must end.
   ``ticket_hash``: 2^20 rows of uniform, zipf and heavy-hitter keys, a
   bound below the distinct count (count > G, key_by_ticket truncated), a
   full 1024-slot table (-1 rows, count = 1024), 2^20 unique keys against
   2^24 slots (the kernel's region mode) and 3·1024 rows (a ragged tile),
   each held by ``ticket_map_discrepancies``.  ``segment_agg``: every
   kind × scatter / onehot over 2^20 rows with tickets of -1 and >= G, and
   every kind (scatter) on a hot key (55% of 2^20 rows, G = 2^14, values
   with -0.0 and, for min/max, ±inf).  ``scan_ticket``
   (``scan_ticket_kernel`` of ``csrc/fused_groupby.cu``, the scan route's
   ticket stage: the fused kernel's morsel dispatch, then tiles through a
   per-CTA key cache with one count atomic per tile): 2^20 rows of
   uniform, zipf and heavy-hitter keys in 4096-row morsels, held by
   ``scan_ticket_discrepancies``; a forced GROW pause (the committed
   morsels whole, no ticket past the bound) and its replay after growing
   the bound; an unchecked, saturated table, which must end.  The
   serialized update's one-thread kernel against its row loop, exactly.
3. main path — ``GroupByPlan(...).stream(...)`` over N = 2^24 rows in 8
   chunks with aggs count(*), sum(v), mean(v), max(v), each stream held
   against a sort-based oracle (``torch.unique`` + float64 ``index_add_``
   + ``scatter_reduce_``).  The fused route (``kernel="fused"``): the
   paper's §4.1 classes (low, high, unique), a grow stream and a
   132-program stream; a RAISE stream must not pause (one launch per
   chunk), and the grow stream may not grow more often than the one-CTA
   rule did (3 bound grows, 3 migrations).  The split route
   (``kernel="split"``): the same three classes, a grow stream and low
   with ``update="onehot"``, with the host-side merge timed apart from the
   kernels.  The scan route (``kernel="off"``: ``scan_ticket`` + the
   update strategies of ``core/updates.py``; ``kernel="scan_body"``:
   ``scan_ticket`` + the segment kernel): low, high, unique and a grow
   stream off; low, high and unique scan_body (a RAISE stream makes one
   ticket launch per chunk and, scan_body, one segment launch per plane
   and chunk); ``update="onehot"`` on low, ``"sort_segment"`` on high, an
   unchecked stream on low; and on 2^16 rows only, ``pipeline="host"``
   (scan_body) and ``update="serialized"``.  Every stream sets the
   launch counts to 0 just before it and reads them just after.
4. timing — CUDA events, median of 5 after 50 ms of warm-up calls, on
   one 2^21-row main-path chunk of each class, beside its bound, its plain
   version and one library call: the fused kernel (low, high, unique at
   P = 1, low at P = 132; library ``torch.unique`` + ``index_add_``), held
   against its plain version on each of those chunks, and swept over CTA
   sizes; the ticket kernel (library
   ``torch.unique(return_inverse=True)``) and the segment kernel per plane
   and strategy (library ``index_add_`` / ``scatter_reduce_``, printed per
   class and kind), each timed beside its plain version and held against
   it on every class's chunk.  The ticket call is also split: allocation
   and fill alone, the launch alone, and ``torch.profiler``'s device time
   per kernel, and its choice of mode
   is timed on the zipf and unique chunks against a 2^25-slot table (the
   mode the sample chooses beside tile mode, forced by one morsel of EMPTY
   rows).  Both
   routes run on the same chunks, and the fused time is printed beside the
   ticket kernel's.  ``scan_ticket`` is timed on the same chunks (4096-row
   morsels, the bound of the class's stream), beside its plain version,
   its bytes bound and ``torch.unique(return_inverse=True)``, and held
   against its plain version on each; its call is split on an idle card
   (the whole call, the wrapper's host work before the launch on the host
   clock, the launch alone) and swept over CTA sizes (256, 512, 1024).
   One ``torch.profiler`` session (a second one records nothing) gives the
   device time of every kernel of one ticket call and one ``scan_ticket``
   call per class.  The serialized kernel on one chunk of its stream (8192
   rows), beside ``index_add_``.

The line before the last two is ``{"kernels": [...]}``, then the card's
name and power limit from ``nvidia-smi``, and the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

M = 1024                        # morsel rows, the fused route's default
SPECS4 = ((-1, "count"), (0, "sum"), (0, "min"), (0, "max"))
KINDS4 = ("sum", "count", "min", "max")
KERNELS = ("fused_groupby", "ticket_hash", "segment_agg")  # CUDA sources
SCAN_M = 4096                   # the scan route's morsel rows (ExecutionPolicy default)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor float32/int32 peak
SUM_RTOL = 1e-4                 # |Δsum| ≤ SUM_RTOL · Σ|v| over the group


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# -- data (benchmarks/common.py gen_keys, on the card) ------------------------


def zipf(n, a, gen, device):
    """Zipf(a) samples by numpy's rejection method, drawn on ``device``."""
    import torch

    am1, b = a - 1.0, 2.0 ** (a - 1.0)
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        v = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1) & (x < 2.0 ** 62) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out


def gen_keys(n, cardinality, dist, gen, device):
    """The paper's §4.1 key classes as ``benchmarks/common.py`` encodes
    them: cardinality low (1000) / high (n // 10) / unique (n); uniform,
    zipf (s = 1.8) or heavy hitter (half the rows on key 7).  int64."""
    import torch

    k = {"low": 1000, "high": max(n // 10, 1), "unique": n}[cardinality]
    if dist == "uniform":
        if cardinality == "unique":
            return torch.randperm(n, generator=gen, device=device)
        return torch.randint(0, k, (n,), generator=gen, device=device)
    if dist == "zipf":
        return torch.remainder(zipf(n, 1.8, gen, device) - 1.0, k).to(torch.int64)
    if dist == "heavy":
        keys = torch.randint(0, k, (n,), generator=gen, device=device)
        hh = torch.rand(n, generator=gen, device=device) < 0.5
        return torch.where(hh, torch.full_like(keys, 7), keys)
    raise ValueError(dist)


def oracle(keys, vals):
    """Sort-based GROUP BY, independent of the port: sorted unique keys,
    counts, float64 sums and |v| sums, max."""
    import torch

    uk, inv, cnt = torch.unique(keys, return_inverse=True, return_counts=True)
    g = uk.numel()
    v64 = vals.double()
    s = torch.zeros(g, dtype=torch.float64, device=keys.device).index_add_(0, inv, v64)
    a = torch.zeros(g, dtype=torch.float64, device=keys.device).index_add_(0, inv, v64.abs())
    mx = torch.full((g,), float("-inf"), device=keys.device).scatter_reduce_(
        0, inv, vals, "amax")
    mn = torch.full((g,), float("inf"), device=keys.device).scatter_reduce_(
        0, inv, vals, "amin")
    return {"keys": uk, "count": cnt, "sum": s, "abs": a, "max": mx, "min": mn}


# -- phase 2: kernel vs plain ---------------------------------------------------


def _by_key(state, p):
    """Program p's groups sorted by key: (keys int64, order into kbt)."""
    import torch

    n = int(state.count[p])
    kb = state.kbt[p, :n].to(torch.int64) & 0xFFFFFFFF
    order = torch.argsort(kb)
    return kb[order], order


def check_tickets(fk, state, label):
    """Gap-free tickets 1..count, each slot's ticket naming its key in
    key_by_ticket."""
    import torch

    for p in range(state.programs):
        n = int(state.count[p])
        occ = state.ttks[p] > 0
        t = state.ttks[p][occ]
        check(torch.equal(torch.sort(t).values.cpu(), torch.arange(1, n + 1, dtype=torch.int32)),
              f"{label}: tickets of program {p} are not 1..{n}")
        inb = t <= state.max_groups
        check(torch.equal(state.kbt[p][(t[inb] - 1).long()], state.tkeys[p][occ][inb]),
              f"{label}: key_by_ticket disagrees with the table in program {p}")


def compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_sum_of, label, *,
                         same_keys=True):
    """The kernel's state vs the plain version's, by the port's rules, for
    launches that leave no morsel todo: info equal, events equal (probe
    steps aside; saturated morsels only by the flag when the table
    saturated, since which morsels saturate depends on the CTAs' order),
    gap-free tickets, and the key → aggregate map.  Returns the largest
    |Δ| seen on any accumulator."""
    import torch

    check(torch.equal(ks.count, ps.count), f"{label}: group counts differ")
    check(not bool(kinfo[:, fk.INFO_HALTED].any()) and not bool(pinfo[:, fk.INFO_HALTED].any()),
          f"{label}: a launch left morsels todo {kinfo.tolist()} vs {pinfo.tolist()}")
    check(torch.equal(kinfo, pinfo), f"{label}: info differs {kinfo.tolist()} vs {pinfo.tolist()}")
    ev_k, ev_p = ks.events.cpu(), ps.events.cpu()
    exact = [0, 1, 2, 5]   # morsels, rows, masked rows, pauses
    if not bool(pinfo[:, fk.INFO_SAT].any()):
        exact.append(4)    # saturated morsels
    check(torch.equal(ev_k[:, exact], ev_p[:, exact]),
          f"{label}: events differ {ev_k.tolist()} vs {ev_p.tolist()}")
    check(torch.equal(ev_k[:, 6:].sum(dim=1), ev_k[:, 1]),
          f"{label}: probe histogram does not sum to the committed rows")
    check_tickets(fk, ks, label + " kernel")
    err = 0.0
    for p in range(ks.programs):
        kk, ko = _by_key(ks, p)
        pk, po = _by_key(ps, p)
        if not same_keys:
            continue
        check(torch.equal(kk, pk), f"{label}: key sets differ in program {p}")
        tol = SUM_RTOL * abs_sum_of(kk)
        for s, (_, kind) in enumerate(SPECS4):
            a, b = ks.accs[s, p][ko], ps.accs[s, p][po]
            d = (a - b).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
            if kind == "sum":
                check(bool((d.double() <= tol).all()), f"{label}: SUM outside tolerance")
            else:
                check(torch.equal(a, b), f"{label}: {kind.upper()} differs")
    return err


def grid_of(fk) -> str:
    ctas, per_program = fk.fused_consume.grid
    return f"grid {ctas} CTAs, {per_program} per program"


def abs_sum_lookup(keys, vals):
    """key → Σ|v| over all rows of the key (the SUM tolerance's scale)."""
    import torch

    o = oracle(keys, vals)

    def of(k):
        idx = torch.searchsorted(o["keys"], k)
        return o["abs"][idx]

    return of


def sync(device=None) -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def timed(fn, *args, **kw):
    """(result, seconds) of one call on the host clock, synchronized."""
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync()
    return out, time.perf_counter() - t0


def phase2(fk, gen, device, n=1 << 20, sat_rows=1 << 13):
    import torch

    from repro_torch.core.hashing import table_capacity

    def ones(k):
        return torch.ones(k, dtype=torch.int32, device=device)

    kinds = tuple(k for _, k in SPECS4)
    max_err = 0.0
    for dist in ("uniform", "zipf", "heavy"):
        keys = gen_keys(n, "high", dist, gen, device)
        vals = torch.randn(n, generator=gen, device=device)
        g = int(torch.unique(keys).numel())
        c = table_capacity(g)
        abs_of = abs_sum_lookup(keys, vals)
        for P in (1, 4):
            km = keys.to(torch.int32).reshape(-1, M).contiguous()
            vm = vals.reshape(1, -1, M).contiguous()
            kw = dict(specs=SPECS4, checked=True, grow_bound=False,
                      threshold=int(0.5 * c), bound_slack=g - M, collect_events=True)
            ks = fk.init_fused_state(capacity=c, max_groups=g, kinds=kinds, programs=P,
                                     device=device)
            ps = fk.init_fused_state(capacity=c, max_groups=g, kinds=kinds, programs=P,
                                     device=device)
            (ks, kinfo), k_s = timed(fk.fused_consume, ks, km, vm, ones(km.shape[0]), **kw)
            (ps, pinfo), p_s = timed(fk.fused_consume_plain, ps, km, vm, ones(km.shape[0]),
                                     **kw)
            label = f"phase2 {dist} P={P}"
            check(fk.fused_consume.grid[1] > 1, f"{label}: one CTA per program")
            err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_of, label)
            max_err = max(max_err, err)
            log(f"{label}: rows={n} groups={g} capacity={c} counts={ks.count.tolist()} "
                f"{grid_of(fk)} max|Δacc|={err:.3g} kernel {k_s * 1e3:.2f} ms plain "
                f"{p_s * 1e3:.0f} ms (host clock, first call) ok")

    # forced pause partway through the chunk (GROW bound of half the
    # groups), grow, replay each version's own todo morsels
    keys = gen_keys(n, "high", "uniform", gen, device)
    vals = torch.randn(n, generator=gen, device=device)
    d = int(torch.unique(keys).numel())
    g1 = d // 2
    c1 = table_capacity(g1)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    npm = km.shape[0]
    ktodo, ptodo = ones(npm), ones(npm)
    kw1 = dict(specs=SPECS4, checked=True, grow_bound=True, threshold=int(0.5 * c1),
               bound_slack=g1 - M, collect_events=True)
    ks = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=kinds, device=device)
    ps = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=kinds, device=device)
    ks, kinfo = fk.fused_consume(ks, km, vm, ktodo, **kw1)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ptodo, **kw1)
    grid = grid_of(fk)
    abs_of = abs_sum_lookup(keys, vals)
    left = int(ktodo.sum())
    check(int(kinfo[0, fk.INFO_HALTED]) == 1 and int(pinfo[0, fk.INFO_HALTED]) == 1
          and 0 < left < npm, f"phase2 pause: expected a halt partway, info {kinfo.tolist()}")
    check(int(kinfo[0, fk.INFO_FIRST_HALT]) == int(torch.nonzero(ktodo)[0]),
          "phase2 pause: info's lowest todo morsel is not the mask's")
    check(int(ks.count[0]) <= g1, f"phase2 pause: {int(ks.count[0])} tickets past G={g1}")
    check_tickets(fk, ks, "phase2 pause kernel")
    count1, p_first = int(ks.count[0]), int(pinfo[0, fk.INFO_FIRST_HALT])
    committed_rows = int((km[ktodo == 0] != -1).sum())
    check(float(ks.accs[0].sum()) == float(committed_rows),
          "phase2 pause: committed morsels' rows not counted exactly once")
    g2 = 4 * g1
    c2 = table_capacity(g2)
    ks = fk.grow_fused_state(ks, kinds, new_max_groups=g2, new_capacity=c2)
    ps = fk.grow_fused_state(ps, kinds, new_max_groups=g2, new_capacity=c2)
    kw2 = dict(kw1, threshold=int(0.5 * c2), bound_slack=g2 - M)
    ks, kinfo = fk.fused_consume(ks, km, vm, ktodo, **kw2)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ptodo, **kw2)
    err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_of, "phase2 resume")
    max_err = max(max_err, err)
    check(int(ks.count[0]) == d, "phase2 resume: group count is not the distinct count")
    check(float(ks.accs[0].sum()) == float(n), "phase2 resume: rows counted twice or lost")
    log(f"phase2 pause: {grid}; {npm - left}/{npm} morsels committed, count {count1} "
        f"with {g1} of {d} groups allowed (plain: halted at morsel {p_first}); replayed "
        f"the todo morsels after growing to {g2}: {grid_of(fk)}, "
        f"counts={ks.count.tolist()} max|Δacc|={err:.3g} ok")

    # unchecked against a saturated table: must end; admitted keys exact
    keys = torch.randint(0, 4096, (sat_rows,), generator=gen, device=device)
    vals = torch.randn(sat_rows, generator=gen, device=device)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    kw3 = dict(specs=SPECS4, checked=False, grow_bound=False, collect_events=True)
    ks = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=kinds, device=device)
    ps = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=kinds, device=device)
    (ks, kinfo), t_kernel = timed(fk.fused_consume, ks, km, vm, ones(km.shape[0]), **kw3)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ones(km.shape[0]), **kw3)
    compare_kernel_plain(fk, ks, kinfo, ps, pinfo, None, "phase2 saturated",
                         same_keys=False)
    check(int(ks.count[0]) == 1024 and int(kinfo[0, fk.INFO_SAT]) == 1,
          f"phase2 saturated: expected a full, saturated table, info {kinfo.tolist()}")
    o = oracle(keys, vals)
    for label, st in (("kernel", ks), ("plain", ps)):
        kk, ko = _by_key(st, 0)
        idx = torch.searchsorted(o["keys"], kk)
        check(torch.equal(o["keys"][idx], kk), f"phase2 saturated {label}: unknown key")
        check(torch.equal(st.accs[0, 0][ko].double(), o["count"][idx].double()),
              f"phase2 saturated {label}: admitted keys' COUNT is not exact")
        check(torch.equal(st.accs[2, 0][ko], o["min"][idx]) and
              torch.equal(st.accs[3, 0][ko], o["max"][idx]),
              f"phase2 saturated {label}: admitted keys' MIN/MAX are not exact")
        d_sum = (st.accs[1, 0][ko].double() - o["sum"][idx]).abs()
        check(bool((d_sum <= SUM_RTOL * o["abs"][idx]).all()),
              f"phase2 saturated {label}: admitted keys' SUM outside tolerance")
    check(int(ks.events[0, 4]) >= 1 and int(ps.events[0, 4]) >= 1,
          "phase2 saturated: no saturated morsel counted")
    log(f"phase2 saturated: rows={sat_rows} distinct≈4096 capacity=1024 -> count=1024, "
        f"saturated morsels {int(ks.events[0, 4])} (plain {int(ps.events[0, 4])}), "
        f"{grid_of(fk)}, kernel ended in {t_kernel:.3f} s ok")
    return max_err


def check_ticket_maps(th, keys, kout, pout, label, *, full=False):
    """The ticket kernel's outputs vs the plain version's by the port's
    contract (``ticket_map_discrepancies``: the same count; one gap-free
    ticket per key, consistent with the kernel's own table and
    key_by_ticket; the same key set and the same -1 rows unless the table
    is full, then a row is -1 iff its key is not in the kernel's table).
    A full table must leave some row unresolved.  Returns the
    discrepancies counted (0 when the check passes)."""
    bad = th.ticket_map_discrepancies(keys, kout, pout, full=full)
    check(bad == 0, f"{label}: {bad} discrepancies from the plain version's ticket map")
    if full:
        check(bool(((keys != -1) & (kout[0] < 0)).any()),
              f"{label}: a full table left no row unresolved")
    return bad


def check_segment(sa, t, v, got, want, kind, label, num_groups):
    """COUNT/MIN/MAX exact, SUM within SUM_RTOL · Σ|v| of the group.
    Returns the largest |Δ|."""
    import torch

    d = (got - want).abs()
    d = d[torch.isfinite(d)]
    err = float(d.max()) if d.numel() else 0.0
    if kind == "sum":
        tol = SUM_RTOL * sa.segment_agg_plain(t, v.abs(), num_groups=num_groups, kind="sum")
        check(bool(((got - want).abs() <= tol).all()), f"{label}: SUM outside tolerance")
    else:
        check(torch.equal(got, want), f"{label}: {kind.upper()} differs")
    return err


def phase2_split(th, sa, gen, device, n=1 << 20, sat_rows=1 << 13):
    """The split route's two kernels vs their plain versions on the card.
    Returns the largest discrepancy of each (check_ticket_maps' count for
    the ticket kernel, |Δacc| for the segment kernel)."""
    import torch

    from repro_torch.core.hashing import table_capacity

    max_err = {"ticket_hash": 0, "segment_agg": 0.0}
    cases = []
    for dist in ("uniform", "zipf", "heavy"):
        keys = gen_keys(n, "high", dist, gen, device).to(torch.int32)
        g = int(torch.unique(keys).numel())
        cases.append((dist, keys, table_capacity(g), g, False))
    keys = gen_keys(n, "high", "uniform", gen, device).to(torch.int32)
    keys[:1000] = -1  # EMPTY padding rows
    g = int(torch.unique(keys[keys != -1]).numel())
    cases.append(("over_bound", keys, table_capacity(g), g // 3, False))
    keys = torch.randint(0, 4096, (sat_rows,), generator=gen, device=device).to(torch.int32)
    cases.append(("full", keys, 1024, 4096, True))
    # every row inserts, 16 slots a row: the kernel builds the table by regions
    keys = torch.randperm(1 << 24, generator=gen, device=device)[:n].to(torch.int32)
    cases.append(("unique_regions", keys, 16 * n, n, False))
    keys = torch.randint(0, 1500, (3 * M,), generator=gen, device=device).to(torch.int32)
    cases.append(("ragged_tile", keys, 4096, 2048, False))
    for label, keys, cap, g, full in cases:
        kout, k_s = timed(th.ticket_hash, keys, capacity=cap, max_groups=g, morsel_size=M)
        pout, p_s = timed(th.ticket_hash_plain, keys, capacity=cap, max_groups=g,
                          morsel_size=M)
        err = check_ticket_maps(th, keys, kout, pout, f"phase2 ticket {label}", full=full)
        max_err["ticket_hash"] = max(max_err["ticket_hash"], err)
        count = int(kout[4])
        if label == "over_bound":
            check(count > g, f"phase2 ticket over_bound: count {count} <= G {g}")
        if full:
            check(count == cap, f"phase2 ticket full: count {count} != {cap}")
        log(f"phase2 ticket {label}: rows={keys.numel()} capacity={cap} G={g} count={count} "
            f"unresolved={int((kout[0] < 0).sum())} kernel {k_s * 1e3:.2f} ms plain "
            f"{p_s * 1e3:.0f} ms (host clock, first call) ok")

    g = 3000
    t = torch.randint(-1, g + 200, (n,), generator=gen, device=device, dtype=torch.int32)
    v = torch.randn(n, generator=gen, device=device)
    for strategy in ("scatter", "onehot"):
        for kind in KINDS4:
            got = sa.segment_agg(t, v, num_groups=g, kind=kind, strategy=strategy,
                                 morsel_size=M)
            want = sa.segment_agg_plain(t, v, num_groups=g, kind=kind, strategy=strategy,
                                        morsel_size=M)
            label = f"phase2 segment {kind}/{strategy}"
            err = check_segment(sa, t, v, got, want, kind, label, g)
            max_err["segment_agg"] = max(max_err["segment_agg"], err)
            log(f"{label}: rows={n} G={g} (tickets -1..{g + 199}) max|Δ|={err:.3g} ok")
    # a hot key: 55% of the rows on one ticket, the rest over G = 2^14
    g = 1 << 14
    t = torch.randint(-1, g + 100, (n,), generator=gen, device=device, dtype=torch.int32)
    t[torch.rand(n, generator=gen, device=device) < 0.55] = 5
    for kind in KINDS4:
        v = torch.randn(n, generator=gen, device=device)
        v[::97] = -0.0
        if kind in ("min", "max"):
            v[2::1013] = float("inf")
            v[3::1009] = float("-inf")
        got = sa.segment_agg(t, v, num_groups=g, kind=kind, morsel_size=M)
        want = sa.segment_agg_plain(t, v, num_groups=g, kind=kind, morsel_size=M)
        label = f"phase2 segment hot key {kind}/scatter"
        err = check_segment(sa, t, v, got, want, kind, label, g)
        max_err["segment_agg"] = max(max_err["segment_agg"], err)
        log(f"{label}: rows={n} G={g} hot ticket on {int((t == 5).sum())} rows "
            f"max|Δ|={err:.3g} ok")
    return max_err


def scan_pair(fk, tk, keys, rows, cap, g, **kw):
    """One ``scan_ticket`` launch and its plain version, each from a fresh
    table of ``cap`` slots and bound ``g``, over ``keys`` in morsels of
    ``rows``: (km, [(tickets, table, todo, info, events), ...], seconds
    of each on the host clock), kernel first."""
    import torch

    km = keys.to(torch.int32).reshape(-1, rows).contiguous()
    out, secs = [], []
    for fn in (fk.scan_ticket, fk.scan_ticket_plain):
        t = tk.make_table(cap, g, device=km.device)
        todo = torch.ones(km.shape[0], dtype=torch.int32, device=km.device)
        ev = torch.zeros(14, dtype=torch.int32, device=km.device)
        (tickets, info), sec = timed(fn, t, km, todo, events=ev, **kw)
        secs.append(sec)
        out.append((tickets, t, todo, info, ev))
    return km, out, secs


def check_scan_events(kev, pev, sat, label):
    """Committed-morsel events of two launches that commit every morsel:
    morsels, rows, masked rows and pauses exact, saturations unless the
    table saturated, the histogram summing to the rows."""
    import torch

    exact = [0, 1, 2, 5] + ([] if sat else [4])
    check(torch.equal(kev[exact].cpu(), pev[exact].cpu()),
          f"{label}: events differ {kev.tolist()} vs {pev.tolist()}")
    check(int(kev[6:].sum()) == int(kev[1]), f"{label}: histogram does not sum to the rows")


def phase2_scan(fk, sa, gen, device, n=1 << 20):
    """The scan route's kernels vs their plain versions on the card: the
    ticket stage (``scan_ticket``, its ``scan_ticket_kernel``)
    and the serialized update's one-thread kernel.  Returns the largest
    discrepancy of each."""
    import torch

    from repro_torch.core import resize
    from repro_torch.core import ticketing as tk
    from repro_torch.core.hashing import table_capacity

    worst = {"scan_ticket": 0, "segment_agg_serialized": 0.0}
    for dist in ("uniform", "zipf", "heavy"):
        keys = gen_keys(n, "high", dist, gen, device).to(torch.int32)
        keys[:777] = -1  # EMPTY rows
        g = int(torch.unique(keys[keys != -1]).numel())
        c = table_capacity(g)
        km, (k, p), (k_s, _) = scan_pair(fk, tk, keys, SCAN_M, c, g, checked=True,
                                    threshold=c // 2, collect_events=True)
        label = f"phase2 scan_ticket {dist}"
        check(torch.equal(k[3], p[3]), f"{label}: info differs {k[3].tolist()} vs {p[3].tolist()}")
        check(not bool(k[2].any()) and fk.scan_ticket.grid[1] > 1,
              f"{label}: morsels left todo or one CTA")
        check_scan_events(k[4], p[4], False, label)
        bad = fk.scan_ticket_discrepancies(km, k[:2], p[:2])
        check(bad == 0, f"{label}: {bad} discrepancies from the plain version's ticket map")
        log(f"{label}: rows={n} groups={g} capacity={c} grid {fk.scan_ticket.grid} "
            f"kernel {k_s * 1e3:.2f} ms (host clock, first call), 0 discrepancies ok")

    # a GROW bound of half the keys: pause partway, replay after the grow
    keys = gen_keys(n, "high", "uniform", gen, device)
    d = int(torch.unique(keys).numel())
    g1 = d // 2
    c = table_capacity(4 * g1)
    kw = dict(checked=True, grow_bound=True, threshold=c // 2, collect_events=True)
    km, (k, p), _ = scan_pair(fk, tk, keys, SCAN_M, c, g1, bound_slack=g1 - SCAN_M, **kw)
    ends = []
    for label, fn, (tickets, t, todo, info, ev) in (("kernel", fk.scan_ticket, k),
                                                   ("plain", fk.scan_ticket_plain, p)):
        left = todo.bool()
        check(int(info[0, fk.INFO_HALTED]) == 1 and 0 < int(left.sum()) < km.shape[0],
              f"phase2 scan pause {label}: no halt partway, info {info.tolist()}")
        check(int(t.count) <= g1, f"phase2 scan pause {label}: tickets past G={g1}")
        check(bool((tickets[left] == -1).all()) and bool((tickets[~left] >= 0).all()),
              f"phase2 scan pause {label}: a morsel committed in part")
        committed = int((~left).sum())
        t2 = resize.grow_bound(t, 4 * g1)
        t2b, info2 = fn(t2, km, todo, bound_slack=4 * g1 - SCAN_M, events=ev, **kw)
        check(int(info2[0, fk.INFO_HALTED]) == 0 and int(t2.count) == d,
              f"phase2 scan resume {label}: info {info2.tolist()}, {d} keys")
        check(int(ev[1]) == n, f"phase2 scan resume {label}: rows counted {int(ev[1])} != {n}")
        ends.append((torch.where(t2b >= 0, t2b, tickets), t2))
        log(f"phase2 scan pause {label}: {committed}/{km.shape[0]} morsels committed with "
            f"{g1} of {d} groups allowed, replayed after growing to {4 * g1} ok")
    bad = fk.scan_ticket_discrepancies(km, ends[0], ends[1])
    check(bad == 0, f"phase2 scan resume: {bad} discrepancies")

    # unchecked against a saturated table: must end
    keys = torch.randint(0, 4096, (1 << 13,), generator=gen, device=device)
    km, (k, p), (k_s, _) = scan_pair(fk, tk, keys, 1024, 1024, 4096, checked=False,
                                collect_events=True)
    check(int(k[1].count) == 1024 and int(k[3][0, fk.INFO_SAT]) == 1 and not bool(k[2].any()),
          f"phase2 scan saturated: expected a full table, every morsel committed, "
          f"info {k[3].tolist()}")
    check_scan_events(k[4], p[4], True, "phase2 scan saturated")
    bad = fk.scan_ticket_discrepancies(km, k[:2], p[:2], full=True)
    check(bad == 0, f"phase2 scan saturated: {bad} discrepancies")
    log(f"phase2 scan saturated: 8192 rows, ≈4096 keys, 1024 slots -> count 1024, "
        f"unresolved {int((k[0] < 0).sum())}, kernel ended in {k_s:.3f} s ok")

    # the serialized update: one thread, rows in order, against its row loop
    t = torch.randint(-1, 3100, (1 << 14,), generator=gen, device=device, dtype=torch.int32)
    v = torch.randn(1 << 14, generator=gen, device=device)
    for kind in KINDS4:
        acc = torch.full((3000,), float("inf") if kind == "min" else
                         float("-inf") if kind == "max" else 0.0, device=device)
        want = sa.serialized_agg_plain(acc.cpu().clone(), t.cpu(), v.cpu(), kind=kind)
        got = sa.serialized_agg(acc, t, v, kind=kind).cpu()
        d = (got - want).abs()
        d = d[torch.isfinite(d)]
        err = float(d.max()) if d.numel() else 0.0
        check(torch.equal(got, want), f"phase2 serialized {kind}: differs from the row loop")
        worst["segment_agg_serialized"] = max(worst["segment_agg_serialized"], err)
        log(f"phase2 serialized {kind}: 16384 rows, G=3000, exact ok")
    return worst


# -- phase 3: the main path -----------------------------------------------------


AGGS_SPEC = (("count", None), ("sum", "v"), ("mean", "v"), ("max", "v"))


def reset_launches(kmods) -> None:
    for mod, fn in kmods.values():
        getattr(mod, fn).launches = 0


def read_launches(kmods) -> dict:
    return {name: getattr(mod, fn).launches for name, (mod, fn) in kmods.items()}


SCAN_KERNELS = (None, "off", "scan_body")


def stream_path(kernel, update, pipeline):
    """The kernels a stream must launch (each at least once)."""
    if kernel == "fused":
        return ("fused_groupby",)
    if kernel == "split":
        return ("ticket_hash", "segment_agg")
    path = () if pipeline == "host" else ("scan_ticket",)
    if kernel == "scan_body":
        path += ("segment_agg",)
    elif update == "serialized":
        path += ("segment_agg_serialized",)
    return path


def run_stream(kmods, api, name, keys, vals, *, max_groups, saturation, programs=1,
               kernel="fused", update=None, chunks=8, pipeline="scan"):
    """One stream of the main path through the plan API, held to the
    oracle.  The launch counts are set to 0 just before it and read just
    after; the split route's host-side merge is timed apart (synchronized
    on both sides, so those times include the device work it waits for)."""
    import torch

    device = keys.device
    aggs = tuple(api.AggSpec(k, c) for k, c in AGGS_SPEC)
    plan = api.GroupByPlan(
        keys=("k",), aggs=aggs, strategy="concurrent", max_groups=max_groups,
        saturation=saturation, raw_keys=True,
        execution=api.ExecutionPolicy(kernel=kernel, morsel_size=M,
                                      kernel_programs=programs, instrument=True,
                                      update=update, device=device.type,
                                      pipeline=pipeline),
    )
    n = keys.shape[0]
    step = n // chunks

    def source():
        for lo in range(0, n, step):
            yield api.Table({"k": keys[lo:lo + step], "v": vals[lo:lo + step]})

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    merge = {"s": 0.0, "calls": 0}
    reset_launches(kmods)
    t0 = time.perf_counter()
    handle = plan.stream(source())
    ex = handle.executor
    if kernel == "split":
        inner = ex._merge

        def timed_merge(partial):
            sync(device)
            m0 = time.perf_counter()
            inner(partial)
            sync(device)
            merge["s"] += time.perf_counter() - m0
            merge["calls"] += 1

        ex._merge = timed_merge
    out = handle.result()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    dev = handle.stats()["device"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    o = oracle(keys, vals)
    g = o["keys"].numel()
    ng = int(out["__num_groups__"][0])
    check(ng == g, f"{name}: {ng} groups, oracle {g}")
    rk = out["key"][:ng]
    order = torch.argsort(rk)
    check(torch.equal(rk[order], o["keys"]), f"{name}: key set differs from the oracle")
    cnt = out["count(*)"][:ng][order]
    check(torch.equal(cnt.double(), o["count"].double()), f"{name}: COUNT not exact")
    check(torch.equal(out["max(v)"][:ng][order], o["max"]), f"{name}: MAX not exact")
    tol = SUM_RTOL * o["abs"]
    d_sum = (out["sum(v)"][:ng][order].double() - o["sum"]).abs()
    check(bool((d_sum <= tol).all()), f"{name}: SUM outside {SUM_RTOL}·Σ|v|")
    c64 = o["count"].double()
    d_mean = (out["mean(v)"][:ng][order].double() - o["sum"] / c64).abs()
    check(bool((d_mean <= tol / c64).all()), f"{name}: MEAN outside tolerance")
    path = stream_path(kernel, update, pipeline)
    for k in path:
        check(launches[k] > 0, f"{name}: the {k} kernel was never launched")
    for k in set(kmods) - set(path):
        check(launches[k] == 0, f"{name}: the {k} kernel ran on the {kernel} route")
    rec = {
        "stream": name, "kernel": kernel, "update": update, "pipeline": pipeline,
        "rows": n, "chunks": chunks,
        "groups": g, "max_groups": max_groups, "saturation": saturation,
        "programs": programs, "wall_s": wall, "rows_per_s": n / wall,
        "max_memory_allocated": peak, "launches": launches,
        "max_sum_err_over_abs": float((d_sum / o["abs"].clamp_min(1e-30)).max()),
    }
    if kernel == "fused":
        fk = kmods["fused_groupby"][0]
        rec.update(migrations=dev["migrations"], bound_grows=dev["bound_grows"],
                   table_capacity=dev["table_capacity"], pauses=dev["pauses"],
                   grid=list(fk.fused_consume.grid))
        check(programs > 1 or fk.fused_consume.grid[1] > 1, f"{name}: one CTA per program")
        if saturation == "raise":
            # a RAISE stream whose groups fit its bound never halts: one
            # launch per chunk, no replay
            check(launches["fused_groupby"] == chunks and dev["pauses"] == 0,
                  f"{name}: a RAISE stream paused ({launches['fused_groupby']} launches "
                  f"for {chunks} chunks, {dev['pauses']} pauses)")
    elif kernel in SCAN_KERNELS:
        planes = len(ex._op._state.specs)
        rec.update(migrations=dev["migrations"], bound_grows=dev["bound_grows"],
                   table_capacity=dev["table_capacity"], pauses=dev["pauses"],
                   planes=planes, grid=list(kmods["scan_ticket"][0].scan_ticket.grid or ()))
        if saturation == "raise" and pipeline == "scan":
            # no pause: one ticket launch per chunk, one update per plane
            check(launches["scan_ticket"] == chunks and dev["pauses"] == 0,
                  f"{name}: {launches['scan_ticket']} ticket launches for {chunks} chunks, "
                  f"{dev['pauses']} pauses")
            if kernel == "scan_body":
                check(launches["segment_agg"] == planes * chunks,
                      f"{name}: {launches['segment_agg']} segment launches for {planes} "
                      f"planes x {chunks} chunks")
    else:
        rec.update(merge_s=merge["s"], merges=merge["calls"], relaunches=ex.relaunches,
                   bound_grows=ex.bound_grows, capacity_grows=ex.capacity_grows,
                   chunk_bound=ex._chunk_bound, chunk_capacity=ex._capacity,
                   carried_bound=ex._max_groups,
                   table_capacity=ex._table.capacity)
    log("phase3 " + json.dumps(rec))
    return rec


def phase3(kmods, api, gen, device, n=1 << 24):
    import torch

    vals = torch.randn(n, generator=gen, device=device)
    recs = []
    low = gen_keys(n, "low", "uniform", gen, device)
    high = gen_keys(n, "high", "zipf", gen, device)
    for kernel, prefix in (("fused", ""), ("split", "split_")):
        recs.append(run_stream(kmods, api, prefix + "low", low, vals, max_groups=1024,
                               saturation="raise", kernel=kernel))
        recs.append(run_stream(kmods, api, prefix + "high", high, vals, max_groups=n // 10,
                               saturation="raise", kernel=kernel))
    del high
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    for kernel, prefix in (("fused", ""), ("split", "split_")):
        recs.append(run_stream(kmods, api, prefix + "unique", uniq, vals, max_groups=n,
                               saturation="raise", kernel=kernel))
    del uniq
    # zipf high keys hold ~1.4e4 groups at this N, under 2^16: the grow
    # streams take the high class's key domain uniformly (~1.68e6 groups)
    high_u = gen_keys(n, "high", "uniform", gen, device)
    for kernel, prefix in (("fused", ""), ("split", "split_")):
        rec = run_stream(kmods, api, prefix + "high_grow", high_u, vals,
                         max_groups=n >> 8, saturation="grow", kernel=kernel)  # 2^16
        check(rec["bound_grows"] >= 1, f"{rec['stream']}: expected a bound grow")
        recs.append(rec)
    check(recs[-2]["bound_grows"] >= 2, "high_grow: expected several bound grows")
    # per-morsel commit flags: a pause with room left relaunches without a
    # grow, so racing CTAs add no growth over the sequential rule's
    check(recs[-2]["bound_grows"] <= 3 and recs[-2]["migrations"] <= 3,
          f"high_grow: {recs[-2]['bound_grows']} bound grows, "
          f"{recs[-2]['migrations']} migrations (3 and 3 with one CTA per program)")
    del high_u
    recs.append(run_stream(kmods, api, "low_p132", low, vals, max_groups=1024,
                           saturation="raise", programs=132))
    recs.append(run_stream(kmods, api, "split_low_onehot", low, vals, max_groups=1024,
                           saturation="raise", kernel="split", update="onehot"))
    recs += phase3_scan(kmods, api, gen, device, low, vals, n)
    return recs


def phase3_scan(kmods, api, gen, device, low, vals, n):
    """The scan route's streams (kernel "off" and "scan_body")."""
    recs = []
    for kernel, prefix in (("off", "scan_"), ("scan_body", "body_")):
        recs.append(run_stream(kmods, api, prefix + "low", low, vals, max_groups=1024,
                               saturation="raise", kernel=kernel))
    recs.append(run_stream(kmods, api, "scan_low_onehot", low, vals, max_groups=1024,
                           saturation="raise", kernel="off", update="onehot"))
    recs.append(run_stream(kmods, api, "scan_low_unchecked", low, vals, max_groups=1024,
                           saturation="unchecked", kernel="off"))
    small = 1 << 16
    recs.append(run_stream(kmods, api, "body_low_host", low[:small], vals[:small],
                           max_groups=1024, saturation="raise", kernel="scan_body",
                           pipeline="host"))
    recs.append(run_stream(kmods, api, "scan_low_serialized", low[:small], vals[:small],
                           max_groups=1024, saturation="raise", kernel="off",
                           update="serialized"))
    high = gen_keys(n, "high", "zipf", gen, device)
    for kernel, prefix in (("off", "scan_"), ("scan_body", "body_")):
        recs.append(run_stream(kmods, api, prefix + "high", high, vals, max_groups=n // 10,
                               saturation="raise", kernel=kernel))
    recs.append(run_stream(kmods, api, "scan_high_sort", high, vals, max_groups=n // 10,
                           saturation="raise", kernel="off", update="sort_segment"))
    del high
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    for kernel, prefix in (("off", "scan_"), ("scan_body", "body_")):
        recs.append(run_stream(kmods, api, prefix + "unique", uniq, vals, max_groups=n,
                               saturation="raise", kernel=kernel))
    del uniq
    high_u = gen_keys(n, "high", "uniform", gen, device)
    rec = run_stream(kmods, api, "scan_high_grow", high_u, vals, max_groups=n >> 8,
                     saturation="grow", kernel="off")
    check(rec["bound_grows"] >= 2, f"scan_high_grow: {rec['bound_grows']} bound grows")
    recs.append(rec)
    return recs


# -- phase 4: timing --------------------------------------------------------------


def time_cuda(fn, reps, setup=None, warm_s=0.05):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events
    around each call only (``setup`` runs before each, untimed).  Calls
    first run back to back for ``warm_s`` seconds, so that a timing does
    not start on a card that sat idle through a host-bound plain
    version."""
    import torch

    t_end = time.perf_counter() + warm_s
    while True:
        if setup is not None:
            setup()
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() >= t_end:
            break
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def kernel_timing(fk, keys, vals, *, max_groups, programs, device, reps=5):
    """The kernel over one main-path chunk from a fresh state, as the
    executor launches it (RAISE, events on).  Returns (ms, launch args)."""
    import torch

    from repro_torch.core.hashing import table_capacity

    kinds = tuple(k for _, k in SPECS4)
    rows = keys.shape[0]
    pad = (-rows) % (M * programs)
    k32 = keys.to(torch.int32)
    v = vals
    if pad:
        k32 = torch.cat([k32, k32.new_full((pad,), -1)])
        v = torch.cat([v, v.new_zeros(pad)])
    km = k32.reshape(-1, M).contiguous()
    vm = v.reshape(1, -1, M).contiguous()
    c = table_capacity(max_groups)
    fresh = fk.init_fused_state(capacity=c, max_groups=max_groups, kinds=kinds,
                                programs=programs, device=device)
    work = fk.FusedState(*(t.clone() for t in fresh))
    todo = torch.ones(km.shape[0], dtype=torch.int32, device=device)
    kw = dict(specs=SPECS4, checked=True, grow_bound=False, threshold=int(0.5 * c),
              bound_slack=max_groups - M, collect_events=True)

    def reset():
        for w, f in zip(work, fresh):
            w.copy_(f)
        todo.fill_(1)

    ms = time_cuda(lambda: fk.fused_consume(work, km, vm, todo, **kw), reps, reset)
    return ms, (fresh, km, vm, kw)


def bound_ms_of(keys, n_value_planes=1, n_specs=4):
    """Least time for one fused pass over ``keys``: every key and value
    row read once, and for each distinct key its table slot (key + ticket)
    read and written, its key_by_ticket entry written and its accumulators
    read and written — over the HBM rate; operations (~12 integer ops per
    row for the hash and probe) over the non-tensor peak.  The larger wins."""
    import torch

    rows = keys.numel()
    d = int(torch.unique(keys).numel())
    nbytes = rows * 4 * (1 + n_value_planes) + d * (16 + 4 + 8 * n_specs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rows * 12 / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_vs_plain(fk, keys, vals, launch, label):
    """The kernel and its plain version, each launched once from the same
    fresh state on the same main-path chunk, compared by the port's rules.
    Returns (max |Δacc|, plain ms on the host clock)."""
    import torch

    fresh, km, vm, kw = launch
    ks = fk.FusedState(*(t.clone() for t in fresh))
    ps = fk.FusedState(*(t.clone() for t in fresh))
    todo = torch.ones(km.shape[0], dtype=torch.int32, device=km.device)
    ks, kinfo = fk.fused_consume(ks, km, vm, todo, **kw)
    (ps, pinfo), p_s = timed(fk.fused_consume_plain, ps, km, vm, todo.clone().fill_(1), **kw)
    err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_sum_lookup(keys, vals), label)
    return err, p_s * 1e3


def phase4_chunks(gen, device, n=1 << 24, chunks=8):
    """One main-path chunk of each class (the first n / chunks rows of the
    class's keys, with their stream's bound) and one value plane: the
    fused and the split kernels are timed on the same chunks."""
    import torch

    rows = n // chunks
    vals = torch.randn(rows, generator=gen, device=device)
    classes = {
        "low": (gen_keys(n, "low", "uniform", gen, device)[:rows], 1024),
        "high": (gen_keys(n, "high", "zipf", gen, device)[:rows], n // 10),
        "unique": (gen_keys(n, "unique", "uniform", gen, device)[:rows], n),
    }
    return classes, vals


def phase4(fk, chunk_classes, vals, device):
    import torch

    from repro_torch.core.hashing import table_capacity

    rows = vals.numel()
    classes = {name: (keys, g, 1) for name, (keys, g) in chunk_classes.items()}
    classes["low_p132"] = (chunk_classes["low"][0], 1024, 132)
    per_class = {}
    max_err = 0.0
    for name, (keys, g, P) in classes.items():
        ms, launch = kernel_timing(fk, keys, vals, max_groups=g, programs=P, device=device)
        grid = list(fk.fused_consume.grid)
        b_ms, b_by = bound_ms_of(keys)
        err, plain_ms = kernel_vs_plain(fk, keys, vals, launch, f"phase4 {name}")
        del launch
        max_err = max(max_err, err)

        def library(keys=keys):
            uk, inv = torch.unique(keys, return_inverse=True)
            torch.zeros(uk.numel(), device=device).index_add_(0, inv, vals)

        lib_ms = time_cuda(library, 5)
        per_class[name] = {"kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err,
                           "rows": rows, "programs": P, "max_groups": g,
                           "capacity": table_capacity(g), "grid": grid}
        log(f"phase4 {name}: kernel {ms:.3f} ms for {rows} rows (P={P}, "
            f"capacity {table_capacity(g)}, grid {grid[0]} CTAs, {grid[1]} per program), "
            f"bound {b_ms:.4f} ms ({b_by}), torch.unique+index_add_ {lib_ms:.3f} ms; "
            f"vs plain ({plain_ms:.1f} ms): max|Δacc|={err:.3g} ok")
    log("phase4 " + json.dumps(per_class))
    high = per_class["high"]
    return {"ms": high["kernel_ms"], "plain_ms": high["plain_ms"],
            "bound_ms": high["bound_ms"], "bound_by": high["bound_by"],
            "library_ms": high["library_ms"], "max_abs_err": max_err,
            "per_class": per_class}


def block_sweep(fk, classes, vals, device, sizes=(128, 256, 512, 1024)):
    """The fused kernel's time per P = 1 chunk at each CTA size (the
    kernel's block size is chosen from these), each launch's group count
    checked against the chunk's distinct count."""
    import torch

    out = {}
    default = fk.BLOCK_THREADS
    try:
        for threads in sizes:
            fk.BLOCK_THREADS = threads
            row = {}
            for name, (keys, g) in classes.items():
                ms, (fresh, km, vm, kw) = kernel_timing(fk, keys, vals, max_groups=g,
                                                        programs=1, device=device)
                ks = fk.FusedState(*(t.clone() for t in fresh))
                todo = torch.ones(km.shape[0], dtype=torch.int32, device=device)
                fk.fused_consume(ks, km, vm, todo, **kw)
                check(int(ks.count[0]) == int(torch.unique(keys).numel())
                      and not bool(todo.any()),
                      f"block sweep {threads} threads {name}: wrong count or morsels left")
                row[name] = {"ms": ms, "grid": list(fk.fused_consume.grid)}
            out[threads] = row
    finally:
        fk.BLOCK_THREADS = default
    log("phase4 block sweep " + json.dumps(out))
    return out


def device_profiles(calls, first_kernels):
    """``torch.profiler``'s device time per kernel over one call of each
    function in ``calls`` (label → fn; each called once untraced first),
    in one profiler session (a second session in the same process recorded
    no device time with torch 2.11 on an H100): label → [(kernel, device
    ms)].  The calls run one after another with a synchronize between, so
    their kernels are told apart by order: each call's first kernel has a
    name in ``first_kernels``, and a call's kernels from that list come
    first and together (matching CPU and device clocks proved unreliable).  Empty lists when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls.values():
        fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label, fn in calls.items():
            with record_function("smoke:" + label):
                fn()
                sync()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("smoke:")),
                     key=lambda e: e.time_range.start)
    groups = []
    prev_first = False
    for e in kernels:
        first = any(k in e.name for k in first_kernels)
        if (first and not prev_first) or not groups:
            groups.append([])
        prev_first = first
        groups[-1].append((e.name[:48], e.time_range.elapsed_us() / 1e3))
    out = {label: [] for label in calls}
    if len(groups) == len(calls):
        out.update(zip(calls, groups))
    return out


def ticket_breakdown(th, k32, cap, g, reps):
    """Where one ticket call's time goes, CUDA events each: the wrapper's
    allocation and fill alone, and the kernel launch alone on outputs
    allocated and filled beforehand (untimed).  Where the shapes allow the
    kernel's region mode (the unique chunk) the fill runs with the launch,
    after the sample, and the first part is the allocation alone."""
    n, dev = k32.numel(), k32.device
    okw = dict(capacity=cap, max_groups=g, device=dev)
    fill_ms = time_cuda(lambda: th.fresh_outputs(n, **okw), reps)
    held = {}

    def setup():
        held["state"] = th.fresh_outputs(n, **okw)

    launch_ms = time_cuda(lambda: th.launch(k32, held["state"]), reps, setup)
    held.clear()
    return {"fill_ms": fill_ms, "launch_ms": launch_ms}


def region_selection(th, classes, reps=5):
    """The ticket kernel's choice of mode on one table past the L2 (C =
    2^25, G = 2^24, as the unique stream's) for the zipf and the unique
    chunk: the chunk as it is (one row per 16 slots: the shapes allow region
    mode and a sample of the keys decides on the card) beside tile mode
    alone (the same chunk and one morsel of EMPTY rows, past one row per
    16 slots, which the shapes rule out).  The zipf chunk, whose keys
    repeat, should cost what tile mode costs; the unique chunk less.  Both
    calls are held against the plain version on the zipf chunk.  Returns
    (record, largest discrepancy)."""
    import torch

    cap, g = 1 << 25, 1 << 24
    out, max_err = {}, 0
    for name in ("high", "unique"):
        k32 = classes[name][0].to(torch.int32)
        n = k32.numel()
        check(16 * n == cap, f"region selection: {n} rows are not C/16")
        padded = torch.cat([k32, k32.new_full((M,), -1)])
        kw = dict(capacity=cap, max_groups=g, morsel_size=M)
        chosen_ms = time_cuda(lambda: th.ticket_hash(k32, **kw), reps)
        tile_ms = time_cuda(lambda: th.ticket_hash(padded, **kw), reps)
        rec = {"rows": n, "groups": int(torch.unique(k32).numel()), "capacity": cap,
               "max_groups": g, "chosen_ms": chosen_ms, "tile_ms": tile_ms,
               "bound_ms": (8 * n + 8 * cap + 4 * g) / HBM_BYTES_PER_S * 1e3}
        if name == "high":
            pout = th.ticket_hash_plain(padded, **kw)
            label = "phase4 region selection zipf"
            err = check_ticket_maps(th, padded, th.ticket_hash(padded, **kw), pout,
                                    label + " tile mode")
            head = (pout[0][:n],) + tuple(pout[1:])
            err = max(err, check_ticket_maps(th, k32, th.ticket_hash(k32, **kw), head,
                                             label + " chosen mode"))
            rec["discrepancies"] = err
            max_err = max(max_err, err)
            del pout, head
        out[name] = rec
        log(f"phase4 region selection {name}: {rec['groups']} keys in {n} rows at C={cap}: "
            f"as chosen {chosen_ms:.4f} ms, tile mode (+{M} EMPTY rows) {tile_ms:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms")
    return out, max_err


def phase4_split(th, sa, classes, vals, device, reps=5):
    """The split route's kernels on one main-path chunk of each class (its
    bound and capacity), CUDA events, beside their bounds, one library
    call each and their plain versions, each held against its plain
    version on that chunk.  Returns (the ticket calls that
    :func:`phase4_profiles` traces, label → fn; the record)."""
    import torch

    from repro_torch.core.hashing import table_capacity

    rows = vals.numel()
    out = {}
    max_err = {"ticket_hash": 0, "segment_agg": 0.0}
    profile_calls = {}
    for name, (keys, g) in classes.items():
        k32 = keys.to(torch.int32)
        cap = table_capacity(g)
        d = int(torch.unique(k32).numel())
        kw = dict(capacity=cap, max_groups=g, morsel_size=M)
        t_ms = time_cuda(lambda: th.ticket_hash(k32, **kw), reps)
        lib_ms = time_cuda(lambda: torch.unique(k32, return_inverse=True), reps)
        breakdown = ticket_breakdown(th, k32, cap, g, reps)
        breakdown.update(call_ms=t_ms, torch_unique_ms=lib_ms)
        log(f"phase4 ticket breakdown {name}: " + json.dumps(breakdown))
        profile_calls[name] = lambda k32=k32, kw=kw: th.ticket_hash(k32, **kw)
        # each input read once, each output written once: keys in, tickets
        # out, the fresh table (keys + tickets) and key_by_ticket out
        t_bytes = 8 * rows + 8 * cap + 4 * g
        rec = {"rows": rows, "groups": d, "max_groups": g, "capacity": cap,
               "ticket": {"kernel_ms": t_ms, "library_ms": lib_ms,
                          "bound_ms": t_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                          "breakdown": breakdown}}
        kout = th.ticket_hash(k32, **kw)
        tickets = kout[0]
        pout, tp_s = timed(th.ticket_hash_plain, k32, **kw)
        t_err = check_ticket_maps(th, k32, kout, pout, f"phase4 ticket {name}")
        max_err["ticket_hash"] = max(max_err["ticket_hash"], t_err)
        rec["ticket"].update(plain_ms=tp_s * 1e3, discrepancies=t_err)
        del pout
        idx = tickets.long()
        check(bool(((idx >= 0) & (idx < g)).all()), f"phase4 {name}: tickets out of range")
        ones = torch.ones(rows, device=device)
        seg = {}
        for kind in KINDS4:
            v = ones if kind == "count" else vals
            if kind in ("sum", "count"):
                def library(v=v):
                    torch.zeros(g, device=device).index_add_(0, idx, v)
            else:
                def library(v=v, kind=kind):
                    torch.full((g,), float("inf") if kind == "min" else float("-inf"),
                               device=device).scatter_reduce_(
                        0, idx, v, "amin" if kind == "min" else "amax")
            lib_seg = time_cuda(library, reps)
            s_bytes = rows * (4 if kind == "count" else 8) + 4 * g + 4 * d
            for strategy in ("scatter", "onehot"):
                if strategy == "onehot" and g > sa.MAX_ONEHOT_GROUPS:
                    continue
                skw = dict(num_groups=g, kind=kind, strategy=strategy, morsel_size=M)
                s_ms = time_cuda(lambda: sa.segment_agg(tickets, vals, **skw), reps)
                got = sa.segment_agg(tickets, vals, **skw)
                want, p_s = timed(sa.segment_agg_plain, tickets, vals, **skw)
                err = check_segment(sa, tickets, vals, got, want, kind,
                                    f"phase4 segment {name} {kind}/{strategy}", g)
                max_err["segment_agg"] = max(max_err["segment_agg"], err)
                seg[f"{kind}/{strategy}"] = {
                    "kernel_ms": s_ms, "plain_ms": p_s * 1e3, "library_ms": lib_seg,
                    "bound_ms": s_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                    "max_abs_err": err}
        rec["segment"] = seg
        out[name] = rec
        for key, r in seg.items():
            log(f"phase4 segment {name} {key}: kernel {r['kernel_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms ({'index_add_' if key[:3] in ('sum', 'cou') else 'scatter_reduce_'}), "
                f"bound {r['bound_ms']:.4f} ms, kernel/library {r['kernel_ms'] / r['library_ms']:.3f}")
        log(f"phase4 split {name}: ticket {t_ms:.3f} ms (torch.unique {lib_ms:.3f} ms, "
            f"bound {rec['ticket']['bound_ms']:.4f} ms; vs plain ({tp_s * 1e3:.1f} ms): "
            f"{t_err} discrepancies); segment sum/scatter "
            f"{seg['sum/scatter']['kernel_ms']:.3f} ms (index_add_ "
            f"{seg['sum/scatter']['library_ms']:.3f} ms, bound "
            f"{seg['sum/scatter']['bound_ms']:.4f} ms) ok")
    selection, sel_err = region_selection(th, classes, reps)
    max_err["ticket_hash"] = max(max_err["ticket_hash"], sel_err)
    # the zipf chunk against the 2^25-slot table too: the sample's cost
    k_high = classes["high"][0].to(torch.int32)
    profile_calls["high_c25"] = lambda: th.ticket_hash(k_high, capacity=1 << 25,
                                                       max_groups=1 << 24, morsel_size=M)
    high = out["high"]
    return profile_calls, {
        "ticket_hash": {"ms": high["ticket"]["kernel_ms"],
                        "plain_ms": high["ticket"]["plain_ms"],
                        "bound_ms": high["ticket"]["bound_ms"], "bound_by": "bytes",
                        "library_ms": high["ticket"]["library_ms"],
                        "max_abs_err": max_err["ticket_hash"]},
        "segment_agg": {"ms": high["segment"]["sum/scatter"]["kernel_ms"],
                        "plain_ms": high["segment"]["sum/scatter"]["plain_ms"],
                        "bound_ms": high["segment"]["sum/scatter"]["bound_ms"],
                        "bound_by": "bytes",
                        "library_ms": high["segment"]["sum/scatter"]["library_ms"],
                        "max_abs_err": max_err["segment_agg"]},
        "per_class": out,
        "region_selection": selection,
    }


def scan_launch(fk, tk, k32, g, device):
    """What one ``scan_ticket`` launch of the scan executor takes on a
    main-path chunk (4096-row morsels, the bound and capacity of the
    class's stream, RAISE, events on): (km, a fresh table, a work table,
    todo, kwargs, reset), where ``reset()`` puts the work table and todo
    back to fresh."""
    import torch

    from repro_torch.core.hashing import table_capacity

    km = k32.reshape(-1, SCAN_M).contiguous()
    cap = table_capacity(g)
    fresh = tk.make_table(cap, g, device=device)
    work = tk.TicketTable(*(t.clone() for t in fresh))
    todo = torch.ones(km.shape[0], dtype=torch.int32, device=device)
    ev = torch.zeros(14, dtype=torch.int32, device=device)
    kw = dict(checked=True, grow_bound=False, threshold=cap // 2,
              bound_slack=g - SCAN_M, collect_events=True, events=ev)

    def reset():
        for w, f in zip(work, fresh):
            w.copy_(f)
        todo.fill_(1)

    return km, fresh, work, todo, kw, reset


def scan_ticket_breakdown(fk, launch, reps):
    """Where one ``scan_ticket`` call's time goes on an idle card (every
    setup ends in a synchronize): the whole call (CUDA events), the
    wrapper's host work before the launch alone (``prepare_scan_ticket``,
    host clock), and the launch alone on a call prepared beforehand
    (``launch_scan_ticket``, CUDA events).  ``phase4_profiles`` adds
    ``torch.profiler``'s device time per kernel of the call."""
    km, _, work, todo, kw, reset = launch
    held = {}

    def idle():
        reset()
        sync()

    def prepared():
        idle()
        held["call"] = fk.prepare_scan_ticket(work, km, todo, **kw)
        sync()

    call_ms = time_cuda(lambda: fk.scan_ticket(work, km, todo, **kw), reps, idle)
    launch_ms = time_cuda(lambda: fk.launch_scan_ticket(held["call"]), reps, prepared)
    host = []
    for _ in range(reps):
        idle()
        t0 = time.perf_counter()
        fk.prepare_scan_ticket(work, km, todo, **kw)
        host.append((time.perf_counter() - t0) * 1e3)
        sync()
    host.sort()
    held.clear()
    return {"call_idle_ms": call_ms, "host_ms": host[len(host) // 2], "launch_ms": launch_ms}


def scan_block_sweep(fk, tk, classes, device, sizes=(256, 512, 1024), reps=5):
    """``scan_ticket``'s time per main-path chunk at each CTA size (its
    block size is chosen from these), each launch's group count checked
    against the chunk's distinct count and every morsel committed."""
    import torch

    out = {}
    default = fk.SCAN_BLOCK_THREADS
    try:
        for threads in sizes:
            fk.SCAN_BLOCK_THREADS = threads
            row = {}
            for name, (keys, g) in classes.items():
                k32 = keys.to(torch.int32)
                km, _, work, todo, kw, reset = scan_launch(fk, tk, k32, g, device)
                ms = time_cuda(lambda: fk.scan_ticket(work, km, todo, **kw), reps, reset)
                reset()
                fk.scan_ticket(work, km, todo, **kw)
                check(int(work.count) == int(torch.unique(k32).numel()) and not bool(todo.any()),
                      f"scan block sweep {threads} threads {name}: wrong count or morsels left")
                row[name] = {"ms": ms, "grid": list(fk.scan_ticket.grid)}
                del work
            out[threads] = row
    finally:
        fk.SCAN_BLOCK_THREADS = default
    log("phase4 scan block sweep " + json.dumps(out))
    return out


def phase4_scan(fk, sa, classes, vals, device, fused_per_class, split_per_class, reps=5):
    """``scan_ticket`` on one main-path chunk of each class (4096-row
    morsels, the bound and capacity of the class's stream, RAISE, events
    on, as the scan executor launches it), CUDA events from a fresh table
    each time, beside its plain version, its bytes bound,
    ``torch.unique(return_inverse=True)``, and the fused and ticket
    kernels on the same chunk; held against its plain version on each,
    its call split by :func:`scan_ticket_breakdown`.  Then the serialized
    kernel on one chunk of its stream (8192 rows).  Returns (the calls
    that :func:`phase4_profiles` traces, label → fn; the record)."""
    import torch

    from repro_torch.core import ticketing as tk

    out, worst, profile_calls = {}, 0, {}
    for name, (keys, g) in classes.items():
        k32 = keys.to(torch.int32)
        rows = k32.numel()
        launch = scan_launch(fk, tk, k32, g, device)
        km, fresh, work, todo, kw, reset = launch
        cap = fresh.capacity
        d = int(torch.unique(k32).numel())
        ms = time_cuda(lambda: fk.scan_ticket(work, km, todo, **kw), reps, reset)
        grid = list(fk.scan_ticket.grid)
        breakdown = scan_ticket_breakdown(fk, launch, reps)
        log(f"phase4 scan_ticket breakdown {name}: " + json.dumps(breakdown))
        # the traced call and its untraced first call each on a fresh table
        # and todo mask, made beforehand
        fresh_pairs = [(tk.TicketTable(*(t.clone() for t in fresh)), torch.ones_like(todo))
                       for _ in range(2)]

        def profiled(km=km, kw=kw, pairs=fresh_pairs):
            table, todo_ = pairs.pop()
            return fk.scan_ticket(table, km, todo_, **kw)

        profile_calls[name] = profiled
        lib_ms = time_cuda(lambda: torch.unique(k32, return_inverse=True), reps)
        km_, (k, p), (_, p_s) = scan_pair(fk, tk, k32, SCAN_M, cap, g, checked=True,
                                          threshold=cap // 2, bound_slack=g - SCAN_M,
                                          collect_events=True)
        bad = fk.scan_ticket_discrepancies(km_, k[:2], p[:2])
        check(bad == 0 and not bool(k[2].any()),
              f"phase4 scan_ticket {name}: {bad} discrepancies")
        worst = max(worst, bad)
        del k, p, work, launch
        # keys read once, tickets written once, and per distinct key its
        # slot (key + ticket) and key_by_ticket entry written once
        b_ms = (8 * rows + 12 * d) / HBM_BYTES_PER_S * 1e3
        out[name] = {"kernel_ms": ms, "plain_ms": p_s * 1e3, "bound_ms": b_ms,
                     "bound_by": "bytes", "library_ms": lib_ms, "discrepancies": bad,
                     "rows": rows, "groups": d, "max_groups": g, "capacity": cap,
                     "grid": grid, "breakdown": breakdown,
                     "fused_ms": fused_per_class[name]["kernel_ms"],
                     "ticket_hash_ms": split_per_class[name]["ticket"]["kernel_ms"]}
        log(f"phase4 scan_ticket {name}: kernel {ms:.4f} ms for {rows} rows in {km.shape[0]} "
            f"morsels (grid {grid[0]} CTAs), bound {b_ms:.4f} ms, torch.unique "
            f"{lib_ms:.4f} ms, plain {p_s * 1e3:.1f} ms; same chunk: fused "
            f"{out[name]['fused_ms']:.4f} ms, ticket_hash {out[name]['ticket_hash_ms']:.4f} ms; "
            f"0 discrepancies ok")
    # the serialized update on one chunk of its stream: 8192 rows, G = 1024
    rows = 8192
    t = classes["low"][0][:rows].to(torch.int32)
    v = vals[:rows].contiguous()
    acc = torch.zeros(1024, device=device)
    s_ms = time_cuda(lambda: sa.serialized_agg(acc, t, v, kind="sum"), reps,
                     lambda: acc.zero_())
    acc.zero_()
    want, p_s = timed(sa.serialized_agg_plain, acc.cpu().clone(), t.cpu(), v.cpu(), kind="sum")
    got = sa.serialized_agg(acc, t, v, kind="sum").cpu()
    check(torch.equal(got, want), "phase4 serialized: differs from the row loop")
    idx = t.long()
    lib = time_cuda(lambda: torch.zeros(1024, device=device).index_add_(0, idx, v), reps)
    # one dependent read-modify-write a row, ~0.5 µs of L2 latency each:
    # the bytes bound (tickets and values read, accumulator written) is printed
    ser = {"ms": s_ms, "plain_ms": p_s * 1e3, "library_ms": lib,
           "bound_ms": (8 * rows + 4 * 1024) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": 0.0, "rows": rows}
    log(f"phase4 serialized: {s_ms:.4f} ms for {rows} rows (one thread), index_add_ "
        f"{lib:.4f} ms, plain {p_s * 1e3:.1f} ms, bound {ser['bound_ms']:.5f} ms, exact ok")
    high = out["high"]
    return profile_calls, {
        "scan_ticket": {"ms": high["kernel_ms"], "plain_ms": high["plain_ms"],
                        "bound_ms": high["bound_ms"], "bound_by": "bytes",
                        "library_ms": high["library_ms"], "max_abs_err": worst},
        "segment_agg_serialized": ser,
        "scan_per_class": out,
    }


def phase4_profiles(timing, ticket_calls, scan_calls):
    """``torch.profiler``'s device time per kernel of one ticket call per
    class (and the zipf chunk at C = 2^25) and one ``scan_ticket`` call per
    class, in the process's one profiler session, attached to each call's
    breakdown in ``timing``."""
    calls = dict(ticket_calls)
    calls.update({"scan_" + name: fn for name, fn in scan_calls.items()})
    # a ticket call starts with the sample or the fill; a scan_ticket call
    # with its scratch fill
    profiles = device_profiles(calls, ("ticket_sample_kernel", "ticket_fill_kernel",
                                       "scan_fill_kernel"))
    for label, rows_ms in profiles.items():
        if label.startswith("scan_"):
            timing["scan_per_class"][label[5:]]["breakdown"]["profile_ms"] = rows_ms
            log(f"phase4 scan_ticket profile {label[5:]}: " + json.dumps(rows_ms))
            continue
        per_class = timing["per_class"]
        rec = (per_class[label]["ticket"]["breakdown"] if label in per_class
               else timing["region_selection"]["high"])
        rec["profile_ms"] = rows_ms
        log(f"phase4 ticket profile {label}: " + json.dumps(rows_ms))
    log("phase4 split " + json.dumps(timing["per_class"]))
    log("phase4 scan " + json.dumps(timing["scan_per_class"]))


def toolchain(build):
    import torch

    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "nvcc": ver[-1] if ver else "?"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import ticketing as tk
    from repro_torch.engine import plan_api as api
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_groupby as fk
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import ticket_hash as th

    # name → (module, wrapper) whose ``launches`` counts that kernel
    kmods = {"fused_groupby": (fk, "fused_consume"), "ticket_hash": (th, "ticket_hash"),
             "segment_agg": (sa, "segment_agg"), "scan_ticket": (fk, "scan_ticket"),
             "segment_agg_serialized": (sa, "serialized_agg")}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t_all = time.perf_counter()

    log("== phase 1: build")
    log("toolchain " + json.dumps(toolchain(build)))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, together
        list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        info = build.BUILD_INFO[name]
        log(f"build {name}: {info['cmd']}")
        log(f"build {name}: {info['seconds']:.2f} s -> {info['path']}")
        for ln in info["ptxas"]:
            log(f"build {name}: ptxas {ln}")
    log(f"phase1 done in {time.perf_counter() - t0:.1f} s")

    log("== phase 2: kernel vs plain on the card")
    t0 = time.perf_counter()
    max_err = phase2(fk, gen, device)
    split_err = phase2_split(th, sa, gen, device)
    split_err.update(phase2_scan(fk, sa, gen, device))
    log(f"phase2 done in {time.perf_counter() - t0:.1f} s")

    log("== phase 3: the main path")
    t0 = time.perf_counter()
    recs = phase3(kmods, api, gen, device)
    launches = {k: sum(r["launches"][k] for r in recs) for k in kmods}
    log(f"phase3 done in {time.perf_counter() - t0:.1f} s; launches {json.dumps(launches)}")

    log("== phase 4: timing")
    t0 = time.perf_counter()
    chunk_classes, chunk_vals = phase4_chunks(gen, device)
    timing = {"fused_groupby": phase4(fk, chunk_classes, chunk_vals, device)}
    block_sweep(fk, chunk_classes, chunk_vals, device)
    ticket_calls, split_timing = phase4_split(th, sa, chunk_classes, chunk_vals, device)
    timing.update(split_timing)
    scan_calls, scan_timing = phase4_scan(fk, sa, chunk_classes, chunk_vals, device,
                                          timing["fused_groupby"]["per_class"],
                                          timing["per_class"])
    timing.update(scan_timing)
    scan_block_sweep(fk, tk, chunk_classes, device)
    phase4_profiles(timing, ticket_calls, scan_calls)
    for name in chunk_classes:
        f_ms = timing["fused_groupby"]["per_class"][name]["kernel_ms"]
        t_ms = timing["per_class"][name]["ticket"]["kernel_ms"]
        log(f"phase4 {name} chunk: fused {f_ms:.3f} ms beside the ticket kernel's "
            f"{t_ms:.3f} ms on the same keys (fused minus ticket {f_ms - t_ms:.3f} ms)")
    timing["fused_groupby"]["max_abs_err"] = max(max_err, timing["fused_groupby"]["max_abs_err"])
    for name, err in split_err.items():
        timing[name]["max_abs_err"] = max(err, timing[name]["max_abs_err"])
    log(f"phase4 done in {time.perf_counter() - t0:.1f} s; "
        f"total {time.perf_counter() - t_all:.1f} s")

    # the scan route's two kernels replace plain jnp, not a Pallas kernel
    replaces = {"fused_groupby": "src/repro/kernels/fused_groupby.py:480",
                "ticket_hash": "src/repro/kernels/ticket_hash.py:193",
                "segment_agg": "src/repro/kernels/segment_agg.py:103",
                "scan_ticket": "src/repro/engine/groupby.py:144",
                "segment_agg_serialized": "src/repro/core/updates.py:226"}
    source = {"scan_ticket": "fused_groupby", "segment_agg_serialized": "segment_agg"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{source.get(name, name)}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": timing[name]["max_abs_err"],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name in kmods]
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(smi[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
