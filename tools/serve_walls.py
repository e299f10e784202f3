#!/usr/bin/env python3
"""Serving walls on the card, in turns, with a batched round's host time
split by stage.

    python3 tools/serve_walls.py [--reps N]

Runs ``chip_smoke.py``'s serving streams (``SERVE_STREAMS``: serve_small
and serve_low, their data made on the card beforehand from seed 0)
through ``AggregationServer`` batched (``batch_queries=True``) and solo,
and as N sequential ``plan.collect``, ``--reps`` turns (default 7) with
the order of the three modes reversed every other turn; each wall is on
the host clock and ends in ``torch.cuda.synchronize()``.  Then one
batched and one solo run of each stream with the host seconds of each
stage summed over the run (host clock, no synchronize inside, so a stage
counts what it costs the host to enqueue, and the info reads wait for
the card): ``stage`` (``GroupByOperator.scan_morsels``: key column and
morsels), ``ticket`` (the call: ``scan_ticket_batched``, which in a
scatter round tickets and folds, or ``scan_ticket``), ``update``
(``GroupByOperator.update_planes``: none in a batched scatter round, the
replays of a paused lane aside), ``info`` (batched: the round's one
blocking read, ``executors.read_round_info``), ``poll`` (solo: the
operator's ``poll``, one info read a chunk), ``round`` (batched:
``consume_batched``), and the wall; then ``scheduler``, the wall less
the rounds (batched) or less the stages (solo), and ``glue``, a batched
round's remainder past its stages.  Prints one JSON line per stream and
a last line ``{stream: {mode: [walls], "split": {...}}}``.
"""
import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.engine import executors as tex  # noqa: E402
from repro_torch.engine import plan_api as api  # noqa: E402
from repro_torch.kernels import fused_groupby as fk  # noqa: E402
from repro_torch.serve import AggregationServer  # noqa: E402

gb = importlib.import_module("repro_torch.engine.groupby")


def run(mode, plan, data, chunk):
    """One run of the stream in ``mode``: (wall seconds, results)."""
    def chunks(k, v):
        return [api.Table({"k": k[i:i + chunk], "v": v[i:i + chunk]})
                for i in range(0, k.shape[0], chunk)]

    cs.sync()
    t0 = time.perf_counter()
    if mode == "sequential":
        outs = [plan.collect(chunks(k, v)) for k, v in data]
    else:
        server = AggregationServer(slots=len(data), batch_queries=mode == "batched")
        handles = [server.submit(plan, chunks(k, v)) for k, v in data]
        server.run_until_idle()
        outs = [h.result() for h in handles]
    cs.sync()
    return time.perf_counter() - t0, outs


def split(mode, plan, data, chunk):
    """Host seconds by stage over one run in ``mode`` (see the module
    docstring), the wall among them."""
    secs = dict.fromkeys(("stage", "ticket", "update", "info", "poll", "round"), 0.0)
    patches = [(gb.GroupByOperator, "scan_morsels", "stage"),
               (gb.GroupByOperator, "update_planes", "update"),
               (gb.GroupByOperator, "poll", "poll"),
               (fk, "scan_ticket_batched", "ticket"), (fk, "scan_ticket", "ticket"),
               (tex, "read_round_info", "info"), (tex, "consume_batched", "round")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            secs[key] += time.perf_counter() - t0
            return out
        call.__dict__ = fn.__dict__  # a wrapper's launch count stays its own
        return call

    try:
        for (obj, name, key), (_, _, fn) in zip(patches, saved):
            setattr(obj, name, timed(fn, key))
        secs["wall"], _ = run(mode, plan, data, chunk)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    if mode == "batched":
        secs["scheduler"] = secs["wall"] - secs["round"]
        secs["glue"] = secs["round"] - sum(secs[k] for k in ("stage", "ticket", "update", "info"))
    else:
        secs["scheduler"] = secs["wall"] - sum(secs[k] for k in ("stage", "ticket", "update",
                                                                  "poll"))
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_walls: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, nq, rows, chunk, card, bound, sat, spec, morsel in cs.SERVE_STREAMS:
        data = [(torch.randint(0, card, (rows,), generator=gen, device=dev, dtype=torch.int32),
                 torch.randn(rows, generator=gen, device=dev)) for _ in range(nq)]
        plan = api.GroupByPlan(
            keys=("k",), aggs=tuple(api.AggSpec(a, c) for a, c in spec),
            strategy="concurrent", max_groups=bound, saturation=sat, raw_keys=True,
            execution=api.ExecutionPolicy(update="scatter", morsel_rows=morsel))
        modes = ("batched", "solo", "sequential")
        run("batched", plan, data, chunk)  # first use: library, allocations
        walls = {m: [] for m in modes}
        for turn in range(args.reps):
            for mode in (modes if turn % 2 == 0 else modes[::-1]):
                walls[mode].append(run(mode, plan, data, chunk)[0])
        rec = dict(walls)
        rec["median"] = {m: sorted(w)[len(w) // 2] for m, w in walls.items()}
        rec["split"] = {m: split(m, plan, data, chunk) for m in ("batched", "solo")}
        out[name] = rec
        print(name, json.dumps(rec), flush=True)
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
