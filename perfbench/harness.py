"""One run of one cell: columns from the seed, a warm-up query, queries back
to back for the window, the reference, the comparison, the metrics.

The program under test is ``repro_torch``'s front door,
``GroupByPlan(keys=[key], aggs, raw_keys=True).stream(chunks).result()``
with every default (``strategy="auto"``, ``max_groups=None``).  Each query
opens a fresh plan and stream over views of the resident columns; nothing
else outlives a query.
"""
from __future__ import annotations

import hashlib
import importlib.util
import random
import resource
import sys
import time
import traceback

import torch

from perfbench import compare, reference, roofline, timeline
from perfbench.record import Query, Run, Span
from perfbench.spec import BENCH_DIR, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def column_seed(seed: int, column: str) -> int:
    """Each column's own generator seed, so a column reads the same whatever
    other columns a cell makes."""
    digest = hashlib.sha256(f"{seed}:{column}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _load(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_columns(cell: Cell, seed: int, device) -> dict:
    cols = {}
    for name, spec in cell.columns.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(column_seed(seed, name))
        cols[name] = _load("columns", spec["kind"]).make(spec, cell.rows, gen, device)
    return cols


def row_bytes(cell: Cell, cols: dict) -> int:
    """Bytes of one row of the columns the query reads, each at its width."""
    return sum(cols[c].element_size() for c in (cell.key, *cell.value_columns))


def kept_queries(seed: int) -> set:
    """The window's queries whose results are compared: the first, one of the
    next seven and one of the 56 after, drawn from the seed."""
    rng = random.Random(seed)
    return {0, 1 + rng.randrange(7), 8 + rng.randrange(56)}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded), each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Program:
    """The system under test, driven the way a user calls it."""

    def __init__(self, cell: Cell, device):
        from repro_torch.engine import AggSpec, ExecutionPolicy, GroupByPlan, Table

        self._cell = cell
        self._plan_type, self._table = GroupByPlan, Table
        self._aggs = [AggSpec(kind, col) for kind, col in cell.aggs]
        # the default plan; only a CPU run names its device
        self._execution = (ExecutionPolicy(device="cpu")
                           if torch.device(device).type == "cpu" else None)

    def chunks(self, cols: dict) -> list:
        n, step = self._cell.rows, self._cell.chunk_rows
        return [self._table({c: t[i:i + step] for c, t in cols.items()})
                for i in range(0, n, step)]

    def query(self, cols: dict):
        """One query: ``(result table, stream handle)``."""
        kw = {} if self._execution is None else {"execution": self._execution}
        plan = self._plan_type(keys=[self._cell.key], aggs=self._aggs, raw_keys=True, **kw)
        handle = plan.stream(self.chunks(cols))
        return handle.result(), handle


def result_map(out) -> tuple:
    """A result ``Table`` → ``(columns, group count)`` for the comparison."""
    n = int(out["__num_groups__"][0]) if out["__num_groups__"].numel() else 0
    return out.columns, n


class _Tracing:
    """The traced run's instruments: the program's spans and event counters,
    and on a card the profiler's device operations over the window."""

    def __init__(self, on_cuda: bool):
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import trace as obs_trace

        self._metrics, self._trace = obs_metrics, obs_trace
        obs_trace.clear()
        obs_trace.enable()
        obs_metrics.enable()
        self._profiler = None
        if on_cuda:
            self._offset_ns = timeline.wall_minus_perf_ns()
            self._profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._profiler.__enter__()

    def close(self, record: Run, host_spans: list) -> None:
        if self._profiler is not None:
            self._profiler.__exit__(None, None, None)
            offset = (self._offset_ns + timeline.wall_minus_perf_ns()) // 2
            record.device_ops = timeline.device_ops(self._profiler, offset)
        self._trace.disable()
        self._metrics.disable()
        record.spans = host_spans + [Span(e["name"], e["ts"], e["ts"] + e["dur"])
                                     for e in self._trace.events() if e.get("ph") == "X"]
        self._trace.clear()


def _memory(device) -> tuple:
    """``(allocated, peak allocated, requested, peak requested)`` since the
    last reset of the peaks, on a card; zeros elsewhere.  Allocated bytes
    count whole allocator blocks, so they depend on which cached block
    served a request; requested bytes count what the program asked for."""
    if torch.device(device).type != "cuda":
        return 0, 0, 0, 0
    s = torch.cuda.memory_stats(device)
    return (s["allocated_bytes.all.current"], s["allocated_bytes.all.peak"],
            s["requested_bytes.all.current"], s["requested_bytes.all.peak"])


def _host_usage() -> tuple:
    """This process's ``(CPU seconds, involuntary context switches)``, and
    the machine's ``(steal, total)`` CPU ticks from ``/proc/stat`` (zeros
    where it cannot be read): time the host's hypervisor gave to others."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
        steal = ticks[7] if len(ticks) > 7 else 0
        total = sum(ticks[:8])
    except (OSError, ValueError):
        steal = total = 0
    return r.ru_utime + r.ru_stime, r.ru_nivcsw, steal, total


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=sys.stderr, stages: str = "") -> dict:
    """One run; returns the result line's object."""
    on_cuda = torch.device(device).type == "cuda"
    program = Program(cell, device)
    t_cols = time.perf_counter()
    cols = make_columns(cell, seed, device)
    sync(device)
    t_warm = time.perf_counter()
    _, handle = program.query(cols)   # warm-up: every chunk shape, the kernels' builds
    sync(device)
    peak = _memory(device)[1]
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    print(f"setup {setup_s:.3f} s: {stages}start to program {t_cols - t_start:.3f}, columns "
          f"{t_warm - t_cols:.3f}, warm-up query {t_end - t_warm:.3f}", file=log, flush=True)
    route = handle.stats()
    print(f"route {route['strategy']}: table and accumulators "
          f"{route['device']['device_table_bytes']} B", file=log, flush=True)
    handle = None

    # the window: queries back to back, one client
    keep = kept_queries(seed)
    kept, queries, host_spans, failed = [], [], [], 0
    tracing = _Tracing(on_cuda) if trace else None
    t0 = time.perf_counter_ns()
    usage0 = _host_usage()
    block_peak = 0
    while not queries or time.perf_counter_ns() - t0 < seconds * 1e9:
        alloc0, seen, req0, _ = _memory(device)
        peak = max(peak, seen)
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(device)
        q0 = time.perf_counter_ns()
        out = handle = None
        try:
            out, handle = program.query(cols)
            sync(device)
        except Exception:
            failed += 1
            if failed <= 3:
                traceback.print_exc(file=log)
        q1 = time.perf_counter_ns()
        q = Query(seconds=(q1 - q0) / 1e9, rows=cell.rows, ok=out is not None)
        if on_cuda:
            _, alloc_peak, _, req_peak = _memory(device)
            q.peak_bytes = req_peak - req0
            block_peak = max(block_peak, alloc_peak - alloc0)
        host_spans.append(Span("query", q0 / 1e3, q1 / 1e3))
        if q.ok and trace:
            q.stats = handle.stats()
        if q.ok and len(queries) in keep:
            kept.append(result_map(out))
        queries.append(q)
        out = handle = None
    t1 = time.perf_counter_ns()
    usage1 = _host_usage()
    peak = max(peak, _memory(device)[1])
    ms = sorted(q.seconds * 1e3 for q in queries)
    print(f"window {(t1 - t0) / 1e9:.3f} s, {len(queries)} queries: first three "
          f"{[round(q.seconds * 1e3, 3) for q in queries[:3]]} ms, median "
          f"{ms[len(ms) // 2]:.3f}, largest {ms[-1]:.3f}", file=log, flush=True)
    ticks = usage1[3] - usage0[3]
    print(f"host: {(usage1[0] - usage0[0]) * 1e3 / len(queries):.3f} ms of CPU a query, "
          f"{usage1[1] - usage0[1]} involuntary switches, steal "
          f"{100 * (usage1[2] - usage0[2]) / ticks if ticks else 0:.3f}% of the machine's "
          f"CPU time; query peak requested "
          f"{max((q.peak_bytes or 0) for q in queries)} B, in allocator blocks {block_peak} B",
          file=log, flush=True)
    record = Run(cell=cell.name, setup_s=setup_s, window_start_us=t0 / 1e3,
                 window_end_us=t1 / 1e3, queries=queries)
    if trace:
        tracing.close(record, host_spans)
        tracing = None

    # the reference, once the window has closed and its peak is read
    ref = reference.groupby(cols[cell.key], cols, cell.aggs)
    readings = [compare.compare(res, n, ref, cell.aggs) for res, n in kept]
    reading = compare.worst(readings) if readings else {
        k: float("inf") for k in compare.numbers_for(cell.aggs)}
    ok, checks = compare.judge(reading, cell.limits)
    name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    record.query_bytes = roofline.query_bytes(
        cell.rows, row_bytes(cell, cols), int(ref["key"].shape[0]), len(cell.aggs))
    record.hbm_bytes_per_s = roofline.hbm_bytes_per_s(name)
    del ref, kept, cols

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = _load("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_cuda else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": ok and failed == 0, "attempted": len(queries), "failed": failed,
            "metrics": metrics, "device": device_info}
    if record.device_ops is not None:
        lo, hi = record.window_start_us, record.window_end_us
        device_info["busy_s"] = timeline.busy_us(record.device_ops, lo, hi) / 1e6
        device_info["window_s"] = record.window_s
        gaps = timeline.idle_gaps(record.device_ops, lo, hi)
        line["breakdown"] = {
            "device_ops": timeline.top(timeline.by_name_us(record.device_ops)),
            "idle_gaps": timeline.top(timeline.idle_by_host(gaps, record.spans)),
        }
    line["checks"] = checks
    return line
