#!/usr/bin/env python3
"""The walls of the streams whose merges, grows, lookups and migrations
reach a carried table, for one source tree, to compare two trees on one
card.

    python3 tools/table_walls.py TREE [STREAM ...]

``TREE`` is a repository root (``chip_smoke.py`` and ``src/``: the working
tree, or a parent unpacked with ``git archive``).  Runs ``chip_smoke.py``'s
phase-3 streams of that tree through its own ``run_stream`` (seed 0, N =
2^24 rows in 8 chunks, the §4 aggs; every stream held to the oracle and
to its route's launches), and prints one line a stream and, last,
``TREE {stream: {wall_s, merge_s, grow_s, route_s, finalize_s}}`` (the
host seconds of the split and partitioned merges, of the grows and of
spill's routing and finalize, each synchronized, where the tree's
chip_smoke records them).  Streams: split_low, split_high, split_unique,
split_high_grow, part_low, part_high, part_unique, part_high_grow,
low_p132, high_grow, scan_high_grow, auto_low, auto_high, auto_unique,
auto_heavy_unique, hybrid_high, hybrid_heavy_unique, spill_low,
spill_high, spill_unique; names after ``TREE`` pick a subset.  In turns,
from the repository root:

    git archive PARENT | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/table_walls.py $t | tail -1; done
"""
import importlib
import json
import os
import sys

TREE = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(TREE, "src"))
sys.path.insert(1, TREE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.engine import plan_api as api  # noqa: E402

# the launch counters of chip_smoke's phase 3: (name, module, wrapper)
KERNELS = (("fused_groupby", "fused_groupby", "fused_consume"),
           ("ticket_hash", "ticket_hash", "ticket_hash"),
           ("segment_agg", "segment_agg", "segment_agg"),
           ("scan_ticket", "fused_groupby", "scan_ticket"),
           ("scan_ticket_batched", "fused_groupby", "scan_ticket_batched"),
           ("segment_agg_serialized", "segment_agg", "serialized_agg"),
           ("hybrid_registers", "hybrid_registers", "hybrid_registers"),
           ("preagg", "preagg", "preagg"),
           ("table_get_or_insert", "table_ops", "get_or_insert"),
           ("table_lookup", "table_ops", "lookup"),
           ("table_migrate", "table_ops", "migrate"))


def kernel_modules() -> dict:
    """chip_smoke's ``kmods`` for the kernels this tree has."""
    out = {}
    for name, module, fn in KERNELS:
        try:
            mod = importlib.import_module(f"repro_torch.kernels.{module}")
        except ImportError:
            continue
        out[name] = (mod, fn)
    return out


def streams(kmods, gen, dev, n=1 << 24):
    """(name, thunk) for each stream, as chip_smoke's phase 3 builds it."""
    vals = torch.randn(n, generator=gen, device=dev)
    keys = {"low": cs.gen_keys(n, "low", "uniform", gen, dev),
            "high": cs.gen_keys(n, "high", "zipf", gen, dev),
            "unique": cs.gen_keys(n, "unique", "uniform", gen, dev),
            "high_u": cs.gen_keys(n, "high", "uniform", gen, dev),
            "heavy_unique": cs.heavy_unique_keys(n, gen, dev)}
    aggs = tuple(api.AggSpec(k, c) for k, c in cs.AGGS_SPEC)
    auto = api.GroupByPlan(keys=("k",), aggs=aggs, execution=api.ExecutionPolicy(instrument=True))
    hybrid = api.GroupByPlan(keys=("k",), aggs=aggs, strategy="hybrid", raw_keys=True,
                             execution=api.ExecutionPolicy(instrument=True))
    bound = {"low": 1024, "high": n // 10, "unique": n}
    one = (("sum", "v"),)

    def run(name, cls, **kw):
        return name, lambda: cs.run_stream(kmods, api, name, keys[cls], vals, **kw)

    out = [run(f"split_{c}", c, max_groups=bound[c], saturation="raise", kernel="split")
           for c in ("low", "high", "unique")]
    out.append(run("split_high_grow", "high_u", max_groups=n >> 8, saturation="grow",
                   kernel="split"))
    out += [run(f"part_{c}", c, max_groups=bound[c], saturation="raise",
                strategy="partitioned", kernel=None,
                aggs_spec=(("count", None),) if c == "low" else one)
            for c in ("low", "high", "unique")]
    out.append(run("part_high_grow", "high_u", max_groups=1 << 16, saturation="grow",
                   strategy="partitioned", kernel=None, aggs_spec=one))
    out.append(run("low_p132", "low", max_groups=1024, saturation="raise", programs=132))
    out.append(run("high_grow", "high_u", max_groups=n >> 8, saturation="grow"))
    out.append(run("scan_high_grow", "high_u", max_groups=n >> 8, saturation="grow",
                   kernel="off"))
    out += [run(f"auto_{c}", c, plan=auto, hashed=True) for c in ("low", "high", "unique")]
    out.append(run("auto_heavy_unique", "heavy_unique", plan=auto, hashed=True))
    out.append(run("hybrid_high", "high", max_groups=n // 10, saturation="raise",
                   strategy="hybrid", kernel="scan_body"))
    out.append(run("hybrid_heavy_unique", "heavy_unique", plan=hybrid))
    out += [run(f"spill_{c}", c, max_groups=budget, saturation="spill", kernel="scan_body")
            for c, budget in (("low", 2048), ("high", 4096), ("unique", 1 << 20))]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("table_walls: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kmods = kernel_modules()
    wanted = set(sys.argv[2:])
    walls = {}
    for name, thunk in streams(kmods, gen, dev):
        if wanted and name not in wanted:
            continue
        rec = thunk()
        walls[name] = {k: rec[k] for k in ("wall_s", "merge_s", "grow_s", "route_s",
                                           "finalize_s") if k in rec}
    print(cs.card_line())
    print(TREE, json.dumps(walls))
    return 0


if __name__ == "__main__":
    sys.exit(main())
