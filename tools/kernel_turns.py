#!/usr/bin/env python3
"""Phase-4 kernel times of one source tree, for comparing two trees on one
card.

    python3 tools/kernel_turns.py SRC_DIR [KERNEL ...]

Times the kernels on ``chip_smoke.py``'s phase-4 chunks (seed 0: one
2^21-row main-path chunk per class, with the bound of the class's stream)
with its own helpers, importing ``repro_torch`` from ``SRC_DIR``: the fused
kernel at P = 1 (``kernel_timing``), the ticket kernel,
``scan_ticket`` (4096-row morsels, the table reset before each call), and,
where ``SRC_DIR`` has it, ``hybrid_registers`` (the main path's planes,
the heavy keys ``detect_heavy_hitters`` names, a heavy-unique chunk, and
R = 64 and 256 on the high chunk), ``segment_agg_serialized`` (8192 rows
into G = 1024, and into the unique class's G = 2^24) and ``preagg`` (W =
8 and 132 workers, C = 1024, kind sum); each of the last three also with
its device time from CUDA-graph replays, as ``<kernel>_graph``, and the
first two with that time after an L2 flush (``<kernel>_cold``);
``hybrid_registers_host_us`` is the wrapper's host time a call.
``grouped_matmul`` (kernel B3) runs on its own inputs (seed 0), not the
chunks: the decode gate / up and down shapes (64 rows over 32 experts)
and the 4096-row prefill shape of ``chip_smoke.GMM_SHAPES``, warm (events),
cold (events, the L2 flushed before each call, ``<kernel>_cold``) and by
CUDA-graph replay (``<kernel>_graph``); per shape, not per class.
``segment_rows`` (kernel B5) runs on its own inputs too: chip_smoke's
phase-4 shapes (the training shape, 1024 rows of d = 1024 at Zipf
tickets, and R = G = 16384), by events, by CUDA-graph replay
(``<kernel>_graph``) and by the wrapper's host µs a call
(``<kernel>_host_us``).
Each is timed three times per class in one process (CUDA events, median
of 5 after 50 ms of warm-up calls), and the script prints ``SRC_DIR
{kernel: {class: [ms, ...]}}``.  Kernels named after ``SRC_DIR`` are the
only ones timed.  To compare a parent tree with the
working tree on one card, unpack the parent into an ignored directory and
run them in turns (from the repository root):

    git archive PARENT src | tar -x -C build/parent
    for t in build/parent/src src src build/parent/src; do
        python3 tools/kernel_turns.py $t | tail -1; done
"""
import importlib.util
import json
import os
import sys
import time

SRC = os.path.abspath(sys.argv[1])
sys.path.insert(0, SRC)
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import ticketing as tk  # noqa: E402
from repro_torch.core.hashing import table_capacity  # noqa: E402
from repro_torch.kernels import fused_groupby as fk  # noqa: E402
from repro_torch.kernels import ticket_hash as th  # noqa: E402


def graph_cold(call, flush):
    """Device ms of ``call`` replayed from a CUDA graph after a 64 MiB
    write that evicts the 50 MB L2 (the write's own graph time taken
    off): the call as it finds a chunk fresh from device memory."""
    return cs.time_graph(lambda: (flush.zero_(), call())) - cs.time_graph(flush.zero_)


def host_us(call, reps=400):
    """Host microseconds per call, on the host clock over ``reps`` calls
    (synchronizing every 50, so the queue never fills)."""
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        call()
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def hybrid_times(classes, vals, dev, flush):
    """``hybrid_registers`` as chip_smoke's phase 4 launches it (R = 8,
    and R = 64 and 256 on the high chunk), three timings a class: the
    event-timed call, the device time from CUDA-graph replays (the
    registers fold on across replays; the fold's work does not depend on
    their values), the same after an L2 flush, and the wrapper's host
    microseconds per call."""
    from repro_torch.core.hybrid import detect_heavy_hitters
    from repro_torch.kernels import hybrid_registers as hr

    chunks = {name: (keys, 8) for name, (keys, _) in classes.items()}
    chunks["heavy_unique"] = (cs.heavy_unique_keys(
        vals.numel(), torch.Generator(device=dev).manual_seed(1), dev), 8)
    chunks["high_r64"] = (classes["high"][0], 64)
    chunks["high_r256"] = (classes["high"][0], 256)
    kinds, planes = ("count", "sum", "count", "max"), [None, vals, None, vals]
    out = {k: {} for k in ("event", "graph", "cold", "host_us")}
    for _ in range(3):
        for name, (keys, r) in chunks.items():
            k32 = keys.to(torch.int32)
            heavy = torch.from_numpy(detect_heavy_hitters(k32, r).view("int32")).to(dev)
            fresh = torch.stack([torch.full((r,), v, device=dev)
                                 for v in (0.0, 0.0, 0.0, -float("inf"))])
            regs = fresh.clone()
            call = lambda: hr.hybrid_registers(k32, heavy, planes, regs, kinds=kinds)  # noqa: E731
            out["event"].setdefault(name, []).append(
                cs.time_cuda(call, 5, lambda: regs.copy_(fresh)))
            out["graph"].setdefault(name, []).append(cs.time_graph(call))
            out["cold"].setdefault(name, []).append(graph_cold(call, flush))
            out["host_us"].setdefault(name, []).append(host_us(call))
    return out


def serialized_times(classes, vals, dev, flush):
    """The serialized update as chip_smoke's phase 4 launches it (8192
    rows of the low chunk into G = 1024, kind sum) and on the first 8192
    rows of the unique chunk into its class's G = 2^24 (past the
    shared-memory plane), three timings each: the event-timed call, the
    device time from CUDA-graph replays, and the same after an L2 flush."""
    from repro_torch.kernels import segment_agg as sa

    rows = 8192
    v = vals[:rows].contiguous()
    cases = {"low_g1024": (classes["low"][0], 1024),
             "unique_g2e24": (classes["unique"][0], classes["unique"][1])}
    out = {k: {} for k in ("event", "graph", "cold")}
    for _ in range(3):
        for name, (keys, g) in cases.items():
            t = keys[:rows].to(torch.int32)
            acc = torch.zeros(g, device=dev)
            call = lambda: sa.serialized_agg(acc, t, v, kind="sum")  # noqa: E731
            out["event"].setdefault(name, []).append(cs.time_cuda(call, 5, acc.zero_))
            out["graph"].setdefault(name, []).append(cs.time_graph(call))
            out["cold"].setdefault(name, []).append(graph_cold(call, flush))
    return out


def preagg_times(classes, vals):
    """``preagg`` as chip_smoke's phase 4 launches it (W = 8 and 132, C =
    1024, kind sum, one morsel a worker), three timings a class: the
    event-timed call, and the device time from CUDA-graph replays."""
    from repro_torch.kernels import preagg as pa

    event, graph = {}, {}
    for _ in range(3):
        for name, (keys, _) in classes.items():
            k32 = cs.to_i32(keys)
            for w in (8, 132):
                kw, vw = cs.preagg_layout(k32, vals, w, w)
                call = lambda: pa.preagg(kw, vw, kind="sum", capacity=cs.PA_C)  # noqa: E731
                event.setdefault(f"{name}_w{w}", []).append(cs.time_cuda(call, 5))
                graph.setdefault(f"{name}_w{w}", []).append(cs.time_graph(call))
    return event, graph


def gmm_times(dev, flush):
    """B3 at ``chip_smoke.GMM_SHAPES`` on the same seeded inputs in every
    tree, three timings a shape: warm and cold (the L2 flushed before each
    call) by events, and by CUDA-graph replay."""
    from repro_torch.kernels import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {name: cs.gmm_case(gen, dev, tokens, k, n)
             for name, (tokens, k, n) in cs.GMM_SHAPES.items()}
    out = {k: {} for k in ("event", "cold", "graph")}
    for _ in range(3):
        for name, (lhs, rhs, sizes) in cases.items():
            call = lambda: gm.grouped_matmul(lhs, rhs, sizes)  # noqa: E731
            out["event"].setdefault(name, []).append(cs.time_cuda(call, 5))
            out["cold"].setdefault(name, []).append(cs.time_cold(call, flush, 5))
            out["graph"].setdefault(name, []).append(cs.time_graph(call))
    return out


def segment_rows_times(dev):
    """B5 at chip_smoke's phase-4 shapes (1024 rows of d = 1024 at the
    tickets of 1024 Zipf ids, G = 1024, and R = G = 16384; seed 1), three
    timings a shape: the event-timed call, the device time from CUDA-graph
    replays, and the wrapper's host microseconds per call."""
    from repro_torch.kernels import segment_rows as sr

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for name, rows_n in (("train", cs.TRAIN_BATCH * cs.TRAIN_SEQ), ("batch_16384", 8 * 2048)):
        _, tickets, _, _, mu, _ = cs.embed_tickets(th, dev, rows=rows_n, seed=1)
        cases[name] = (torch.randn(mu, 1024, generator=gen, device=dev), tickets, mu)
    out = {k: {} for k in ("event", "graph", "host_us")}
    for _ in range(3):
        for name, (rows, tickets, mu) in cases.items():
            call = lambda: sr.segment_rows(rows, tickets, mu)  # noqa: E731
            out["event"].setdefault(name, []).append(cs.time_cuda(call, 5))
            out["graph"].setdefault(name, []).append(cs.time_graph(call))
            out["host_us"].setdefault(name, []).append(host_us(call))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    only = set(sys.argv[2:])

    module = {"scan_ticket": "fused_groupby", "segment_agg_serialized": "segment_agg"}

    def wanted(kernel):
        return (not only or kernel in only) and importlib.util.find_spec(
            "repro_torch.kernels." + module.get(kernel, kernel)) is not None

    chunked = ("fused_groupby", "ticket_hash", "scan_ticket", "hybrid_registers",
               "segment_agg_serialized", "preagg")
    if any(wanted(k) for k in chunked):
        classes, vals = cs.phase4_chunks(torch.Generator(device=dev).manual_seed(0), dev)
    out = {k: {} for k in ("fused_groupby", "ticket_hash", "scan_ticket") if wanted(k)}
    for _ in range(3 if out else 0):
        for name, (keys, g) in classes.items():
            k32 = keys.to(torch.int32)
            if wanted("fused_groupby"):
                ms, _ = cs.kernel_timing(fk, keys, vals, max_groups=g, programs=1, device=dev)
                out["fused_groupby"].setdefault(name, []).append(ms)
            if wanted("ticket_hash"):
                kw = dict(capacity=table_capacity(g), max_groups=g, morsel_size=cs.M)
                ms = cs.time_cuda(lambda: th.ticket_hash(k32, **kw), 5)
                out["ticket_hash"].setdefault(name, []).append(ms)
            if wanted("scan_ticket"):
                km, _, work, todo, skw, reset = cs.scan_launch(fk, tk, k32, g, dev)
                ms = cs.time_cuda(lambda: fk.scan_ticket(work, km, todo, **skw), 5, reset)
                out["scan_ticket"].setdefault(name, []).append(ms)
                del work
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for kernel, times in (("hybrid_registers", hybrid_times),
                          ("segment_agg_serialized", serialized_times)):
        if wanted(kernel):
            for kind, per_class in times(classes, vals, dev, flush).items():
                out[kernel if kind == "event" else f"{kernel}_{kind}"] = per_class
    if wanted("preagg"):
        out["preagg"], out["preagg_graph"] = preagg_times(classes, vals)
    if wanted("grouped_matmul"):
        for kind, per_shape in gmm_times(dev, flush).items():
            out["grouped_matmul" if kind == "event" else f"grouped_matmul_{kind}"] = per_shape
    if wanted("segment_rows"):
        for kind, per_shape in segment_rows_times(dev).items():
            out["segment_rows" if kind == "event" else f"segment_rows_{kind}"] = per_shape
    print(sys.argv[1], json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
