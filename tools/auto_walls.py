#!/usr/bin/env python3
"""Where the default plan's time goes on the low class, on one card.

    python3 tools/auto_walls.py [SRC_DIR]

Streams ``chip_smoke.py``'s low class (seed 0: 2^24 rows uniform over
1000 keys, 8 chunks, the §4 aggs) through five plans, three passes each
(host clock, synchronized; the first pass of a process pays first-use
costs), and prints the walls:

  auto_hashed       ``GroupByPlan(keys, aggs)``: every default (hashed key)
  auto_raw          the same on the raw key column
  body_none_raw     ``strategy="concurrent"``, kernel scan_body, max_groups
                    None (resolved from the sample, saturation GROW)
  body_2048_raw     the same with ``max_groups=2048`` (RAISE)
  body_2048_hashed  the same on the hashed key column

then ``torch.profiler``'s device time per kernel over one auto_hashed
stream (its ten largest).  ``SRC_DIR`` (default ``src``) is where
``repro_torch`` is imported from.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.engine import plan_api as api  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("auto_walls: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 24
    step = n // 8
    vals = torch.randn(n, generator=gen, device=dev)
    low = cs.gen_keys(n, "low", "uniform", gen, dev)
    aggs = tuple(api.AggSpec(k, c) for k, c in cs.AGGS_SPEC)
    body = api.ExecutionPolicy(kernel="scan_body")
    plans = {
        "auto_hashed": api.GroupByPlan(keys=("k",), aggs=aggs),
        "auto_raw": api.GroupByPlan(keys=("k",), aggs=aggs, raw_keys=True),
        "body_none_raw": api.GroupByPlan(keys=("k",), aggs=aggs, raw_keys=True,
                                         strategy="concurrent", execution=body),
        "body_2048_raw": api.GroupByPlan(keys=("k",), aggs=aggs, raw_keys=True,
                                         strategy="concurrent", max_groups=2048,
                                         execution=body),
        "body_2048_hashed": api.GroupByPlan(keys=("k",), aggs=aggs, strategy="concurrent",
                                            max_groups=2048, execution=body),
    }

    def run(plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan.collect(api.Table({"k": low[i:i + step], "v": vals[i:i + step]})
                     for i in range(0, n, step))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for rep in range(3):
        print(f"pass {rep}: " + ", ".join(f"{k} {run(p):.4f} s" for k, p in plans.items()),
              flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(plans["auto_hashed"])
    rows = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)[:10]
    for e in rows:
        print(f"profile auto_hashed: {e.key[:60]}: {e.count} calls, "
              f"{e.self_device_time_total / 1e3:.3f} ms on the device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
