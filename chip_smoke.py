#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero, printing no result, without them.
Four phases, each of which fails the run:

1. build — compile the port's CUDA source with ``nvcc`` and print the
   command, the seconds and ``-Xptxas -v``.
2. kernel vs plain — call ``fused_consume`` (the Hopper kernel) and
   ``fused_consume_plain`` on the same CUDA tensors: 2^20 rows of uniform,
   zipf and heavy-hitter keys at P = 1 and 4 under an exact bound; a forced
   pause and its relaunch after ``grow_fused_state``; and an unchecked,
   saturated table (1024 slots, 4096 distinct keys), which must end.
3. main path — ``GroupByPlan(kernel="fused").stream(...)`` over N = 2^24
   rows in 8 chunks with aggs count(*), sum(v), mean(v), max(v), for the
   paper's §4.1 classes (low, high, unique), a grow stream and a
   132-program stream, each held against a sort-based oracle
   (``torch.unique`` + float64 ``index_add_`` + ``scatter_reduce_``).
4. timing — the kernel with CUDA events on one main-path chunk of each
   class (its table, bound and program count: low, high, unique at P = 1,
   low at P = 132), beside its bound, the plain version and
   ``torch.unique`` + ``index_add_`` as the library yardstick; on each of
   those chunks the kernel is also held against its plain version.

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

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

M = 1024                        # morsel rows, the fused route's default
SPECS4 = ((-1, "count"), (0, "sum"), (0, "min"), (0, "max"))
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
    """The kernel's state vs the plain version's, by the port's rules.
    Returns the largest |Δ| seen on any accumulator."""
    import torch

    check(torch.equal(ks.count, ps.count), f"{label}: group counts differ")
    check(torch.equal(kinfo[:, [fk.INFO_COUNT, fk.INFO_SAT, fk.INFO_HALTED]],
                      pinfo[:, [fk.INFO_COUNT, fk.INFO_SAT, fk.INFO_HALTED]]),
          f"{label}: info differs {kinfo.tolist()} vs {pinfo.tolist()}")
    if not bool(pinfo[:, fk.INFO_SAT].any()):
        check(torch.equal(kinfo[:, fk.INFO_FIRST_HALT], pinfo[:, fk.INFO_FIRST_HALT]),
              f"{label}: first halted morsel differs")
    ev_k, ev_p = ks.events.cpu(), ps.events.cpu()
    exact = [0, 1, 2, 4, 5]   # morsels, rows, masked rows, saturations, pauses
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


def abs_sum_lookup(keys, vals):
    """key → Σ|v| over all rows of the key (the SUM tolerance's scale)."""
    import torch

    o = oracle(keys, vals)

    def of(k):
        idx = torch.searchsorted(o["keys"], k)
        return o["abs"][idx]

    return of


def timed(fn, *args, **kw):
    """(result, seconds) of one call on the host clock, synchronized."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync()
    return out, time.perf_counter() - t0


def phase2(fk, gen, device, n=1 << 20, sat_rows=1 << 13):
    import torch

    from repro_torch.core.hashing import table_capacity

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
            start = torch.zeros(P, dtype=torch.int32, device=device)
            kw = dict(specs=SPECS4, checked=True, grow_bound=False,
                      threshold=int(0.5 * c), bound_slack=g - M, collect_events=True)
            ks = fk.init_fused_state(capacity=c, max_groups=g, kinds=kinds, programs=P,
                                     device=device)
            ps = fk.init_fused_state(capacity=c, max_groups=g, kinds=kinds, programs=P,
                                     device=device)
            (ks, kinfo), k_s = timed(fk.fused_consume, ks, km, vm, start, **kw)
            (ps, pinfo), p_s = timed(fk.fused_consume_plain, ps, km, vm, start, **kw)
            label = f"phase2 {dist} P={P}"
            err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_of, label)
            max_err = max(max_err, err)
            log(f"{label}: rows={n} groups={g} capacity={c} counts={ks.count.tolist()} "
                f"max|Δacc|={err:.3g} kernel {k_s * 1e3:.2f} ms plain {p_s * 1e3:.0f} ms "
                "(host clock, first call) ok")

    # forced pause partway through the chunk, grow, relaunch at first_halt
    keys = gen_keys(n, "high", "uniform", gen, device)
    vals = torch.randn(n, generator=gen, device=device)
    d = int(torch.unique(keys).numel())
    g1 = d // 2
    c1 = table_capacity(g1)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    kw1 = dict(specs=SPECS4, checked=True, grow_bound=True, threshold=int(0.5 * c1),
               bound_slack=g1 - M, collect_events=True)
    ks = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=kinds, device=device)
    ps = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=kinds, device=device)
    ks, kinfo = fk.fused_consume(ks, km, vm, zero, **kw1)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, zero, **kw1)
    abs_of = abs_sum_lookup(keys, vals)
    compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_of, "phase2 pause")
    first = int(kinfo[0, fk.INFO_FIRST_HALT])
    npm = km.shape[0]
    check(int(kinfo[0, fk.INFO_HALTED]) == 1 and 0 < first < npm,
          f"phase2 pause: expected a halt partway, info {kinfo.tolist()}")
    g2 = 4 * g1
    c2 = table_capacity(g2)
    ks = fk.grow_fused_state(ks, kinds, new_max_groups=g2, new_capacity=c2)
    ps = fk.grow_fused_state(ps, kinds, new_max_groups=g2, new_capacity=c2)
    resume = torch.tensor([first], dtype=torch.int32, device=device)
    kw2 = dict(kw1, threshold=int(0.5 * c2), bound_slack=g2 - M)
    ks, kinfo = fk.fused_consume(ks, km, vm, resume, **kw2)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, resume, **kw2)
    err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_of, "phase2 resume")
    max_err = max(max_err, err)
    check(int(kinfo[0, fk.INFO_HALTED]) == 0, "phase2 resume: halted again")
    check(int(ks.count[0]) == d, "phase2 resume: group count is not the distinct count")
    check(float(ks.accs[0].sum()) == float(n), "phase2 resume: rows counted twice or lost")
    log(f"phase2 pause: halted at morsel {first}/{npm} with {g1} of {d} groups allowed; "
        f"resumed after growing to {g2}: counts={ks.count.tolist()} max|Δacc|={err:.3g} ok")

    # unchecked against a saturated table: must end; admitted keys exact
    keys = torch.randint(0, 4096, (sat_rows,), generator=gen, device=device)
    vals = torch.randn(sat_rows, generator=gen, device=device)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    kw3 = dict(specs=SPECS4, checked=False, grow_bound=False, collect_events=True)
    ks = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=kinds, device=device)
    ps = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=kinds, device=device)
    (ks, kinfo), t_kernel = timed(fk.fused_consume, ks, km, vm, zero, **kw3)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, zero, **kw3)
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
    log(f"phase2 saturated: rows={sat_rows} distinct≈4096 capacity=1024 -> count=1024, "
        f"saturations={int(ks.events[0, 4])}, kernel ended in {t_kernel:.3f} s ok")
    return max_err


# -- phase 3: the main path -----------------------------------------------------


AGGS_SPEC = (("count", None), ("sum", "v"), ("mean", "v"), ("max", "v"))


def run_stream(fk, api, name, keys, vals, *, max_groups, saturation, programs,
               chunks=8):
    import torch

    device = keys.device
    aggs = tuple(api.AggSpec(k, c) for k, c in AGGS_SPEC)
    plan = api.GroupByPlan(
        keys=("k",), aggs=aggs, strategy="concurrent", max_groups=max_groups,
        saturation=saturation, raw_keys=True,
        execution=api.ExecutionPolicy(kernel="fused", morsel_size=M,
                                      kernel_programs=programs, instrument=True,
                                      device=device.type),
    )
    n = keys.shape[0]
    step = n // chunks

    def source():
        for lo in range(0, n, step):
            yield api.Table({"k": keys[lo:lo + step], "v": vals[lo:lo + step]})

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    fk.fused_consume.launches = 0
    t0 = time.perf_counter()
    handle = plan.stream(source())
    out = handle.result()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = fk.fused_consume.launches
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
    check(launches > 0, f"{name}: the fused kernel was never launched")
    rec = {
        "stream": name, "rows": n, "chunks": chunks, "groups": g,
        "max_groups": max_groups, "saturation": saturation, "programs": programs,
        "wall_s": wall, "rows_per_s": n / wall, "max_memory_allocated": peak,
        "launches": launches, "migrations": dev["migrations"],
        "bound_grows": dev["bound_grows"], "table_capacity": dev["table_capacity"],
        "max_sum_err_over_abs": float((d_sum / o["abs"].clamp_min(1e-30)).max()),
    }
    log("phase3 " + json.dumps(rec))
    return rec


def phase3(fk, api, gen, device, n=1 << 24):
    import torch

    vals = torch.randn(n, generator=gen, device=device)
    recs = []
    low = gen_keys(n, "low", "uniform", gen, device)
    recs.append(run_stream(fk, api, "low", low, vals, max_groups=1024,
                           saturation="raise", programs=1))
    high = gen_keys(n, "high", "zipf", gen, device)
    recs.append(run_stream(fk, api, "high", high, vals, max_groups=n // 10,
                           saturation="raise", programs=1))
    del high
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    recs.append(run_stream(fk, api, "unique", uniq, vals, max_groups=n,
                           saturation="raise", programs=1))
    del uniq
    # zipf high keys hold ~1.4e4 groups at this N, under 2^16: the grow
    # stream takes the high class's key domain uniformly (~1.68e6 groups)
    high_u = gen_keys(n, "high", "uniform", gen, device)
    rec = run_stream(fk, api, "high_grow", high_u, vals, max_groups=n >> 8,
                     saturation="grow", programs=1)  # 2^16 at N = 2^24
    check(rec["bound_grows"] >= 2, "high_grow: expected several bound grows")
    recs.append(rec)
    del high_u
    recs.append(run_stream(fk, api, "low_p132", low, vals, max_groups=1024,
                           saturation="raise", programs=132))
    return recs


# -- phase 4: timing --------------------------------------------------------------


def time_cuda(fn, reps, setup=None):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events
    around each call only (``setup`` runs before each, untimed)."""
    import torch

    times = []
    for _ in range(reps + 1):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times = sorted(times[1:])  # first run warms up
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
    start = torch.zeros(programs, dtype=torch.int32, device=device)
    kw = dict(specs=SPECS4, checked=True, grow_bound=False, threshold=int(0.5 * c),
              bound_slack=max_groups - M, collect_events=True)

    def reset():
        for w, f in zip(work, fresh):
            w.copy_(f)

    ms = time_cuda(lambda: fk.fused_consume(work, km, vm, start, **kw), reps, reset)
    return ms, (fresh, km, vm, start, kw)


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
    fresh, km, vm, start, kw = launch
    ks = fk.FusedState(*(t.clone() for t in fresh))
    ps = fk.FusedState(*(t.clone() for t in fresh))
    ks, kinfo = fk.fused_consume(ks, km, vm, start, **kw)
    (ps, pinfo), p_s = timed(fk.fused_consume_plain, ps, km, vm, start, **kw)
    err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_sum_lookup(keys, vals), label)
    return err, p_s * 1e3


def phase4(fk, gen, device, n=1 << 24, chunks=8):
    import torch

    from repro_torch.core.hashing import table_capacity

    rows = n // chunks
    vals = torch.randn(rows, generator=gen, device=device)
    low = gen_keys(n, "low", "uniform", gen, device)[:rows]
    classes = {
        "low": (low, 1024, 1),
        "high": (gen_keys(n, "high", "zipf", gen, device)[:rows], n // 10, 1),
        "unique": (gen_keys(n, "unique", "uniform", gen, device)[:rows], n, 1),
        "low_p132": (low, 1024, 132),
    }
    per_class = {}
    max_err = 0.0
    for name, (keys, g, P) in classes.items():
        ms, launch = kernel_timing(fk, keys, vals, max_groups=g, programs=P, device=device)
        b_ms, b_by = bound_ms_of(keys)
        err, plain_ms = kernel_vs_plain(fk, keys, vals, launch, f"phase4 {name}")
        del launch
        max_err = max(max_err, err)
        per_class[name] = {"kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "max_abs_err": err, "rows": rows,
                           "programs": P, "max_groups": g,
                           "capacity": table_capacity(g)}
        log(f"phase4 {name}: kernel {ms:.3f} ms for {rows} rows (P={P}, "
            f"capacity {table_capacity(g)}), bound {b_ms:.4f} ms ({b_by}); "
            f"vs plain ({plain_ms:.1f} ms): max|Δacc|={err:.3g} ok")
    log("phase4 " + json.dumps(per_class))
    keys = classes["high"][0]

    def library():
        uk, inv = torch.unique(keys, return_inverse=True)
        torch.zeros(uk.numel(), device=device).index_add_(0, inv, vals)

    lib_ms = time_cuda(library, 5)
    high = per_class["high"]
    log(f"phase4 high chunk: kernel {high['kernel_ms']:.3f} ms, plain "
        f"{high['plain_ms']:.1f} ms, torch.unique+index_add_ {lib_ms:.3f} ms, "
        f"bound {high['bound_ms']:.4f} ms")
    return {"ms": high["kernel_ms"], "plain_ms": high["plain_ms"],
            "bound_ms": high["bound_ms"], "bound_by": high["bound_by"],
            "library_ms": lib_ms, "max_abs_err": max_err, "per_class": per_class}


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
    from repro_torch.engine import plan_api as api
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_groupby as fk

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t_all = time.perf_counter()

    log("== phase 1: build")
    log("toolchain " + json.dumps(toolchain(build)))
    t0 = time.perf_counter()
    build.build("fused_groupby")
    for name, info in sorted(build.BUILD_INFO.items()):
        log(f"build {name}: {info['cmd']}")
        log(f"build {name}: {info['seconds']:.2f} s -> {info['path']}")
        for ln in info["ptxas"]:
            log(f"build {name}: ptxas {ln}")
    log(f"phase1 done in {time.perf_counter() - t0:.1f} s")

    log("== phase 2: kernel vs plain on the card")
    t0 = time.perf_counter()
    max_err = phase2(fk, gen, device)
    log(f"phase2 done in {time.perf_counter() - t0:.1f} s")

    log("== phase 3: the main path")
    t0 = time.perf_counter()
    recs = phase3(fk, api, gen, device)
    launches = sum(r["launches"] for r in recs)
    log(f"phase3 done in {time.perf_counter() - t0:.1f} s; fused launches {launches}")

    log("== phase 4: timing")
    t0 = time.perf_counter()
    timing = phase4(fk, gen, device)
    log(f"phase4 done in {time.perf_counter() - t0:.1f} s; "
        f"total {time.perf_counter() - t_all:.1f} s")

    kernels = [{
        "name": "fused_groupby",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_groupby.cu",
        "replaces": "src/repro/kernels/fused_groupby.py:480",
        "launches": launches,
        "max_abs_err": max(max_err, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
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
