#!/usr/bin/env python3
"""Fused-route stream walls of one source tree, for comparing two trees on
one card.

    python3 tools/fused_walls.py SRC_DIR

Runs the fused route's phase-3 streams of ``chip_smoke.py`` (low, high,
unique and high_grow: N = 2^24 rows in 8 chunks, the same aggregates and
bounds) three times each in one process, importing ``repro_torch`` from
``SRC_DIR``, and prints ``SRC_DIR {stream: [wall seconds, ...]}``.  The
first pass of a stream also pays the kernel build and the allocator's
first allocations of its size.  To compare a parent tree with the working
tree on one card, unpack the parent into an ignored directory and run
them in turns (from the repository root):

    git archive HEAD src | tar -x -C build/parent
    for t in build/parent/src src src build/parent/src; do
        python3 tools/fused_walls.py $t | tail -1; done
"""
import json
import os
import sys
import time

SRC = os.path.abspath(sys.argv[1])
sys.path.insert(0, SRC)
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.engine import plan_api as api  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_walls: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 24
    vals = torch.randn(n, generator=gen, device=dev)
    streams = {"low": (cs.gen_keys(n, "low", "uniform", gen, dev), 1024, "raise"),
               "high": (cs.gen_keys(n, "high", "zipf", gen, dev), n // 10, "raise"),
               "unique": (cs.gen_keys(n, "unique", "uniform", gen, dev), n, "raise"),
               "high_grow": (cs.gen_keys(n, "high", "uniform", gen, dev), n >> 8, "grow")}
    aggs = tuple(api.AggSpec(k, c) for k, c in cs.AGGS_SPEC)
    step = n // 8
    walls = {}
    for _ in range(3):
        for name, (keys, g, sat) in streams.items():
            plan = api.GroupByPlan(
                keys=("k",), aggs=aggs, strategy="concurrent", max_groups=g,
                saturation=sat, raw_keys=True,
                execution=api.ExecutionPolicy(kernel="fused", morsel_size=1024,
                                              instrument=True, device="cuda"))
            chunks = [api.Table({"k": keys[i:i + step], "v": vals[i:i + step]})
                      for i in range(0, n, step)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.collect(chunks)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
    print(sys.argv[1], json.dumps(walls))
    return 0


if __name__ == "__main__":
    sys.exit(main())
