"""The readings that the limits of ``limits/<cell>.json`` are set from, at a
cell's own size on the card: the program's on many seeds, and the
control's (the reference with bfloat16 planes in the program's place), or
a planted fault's, on a few.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault half_batch --fault-seeds 7,8,9] [--rows N]

Each seed: the columns, a warm-up query, as many queries through the timed
path as a run compares, the reference, and one JSON line with each
number's largest reading over those queries.  ``--rows`` runs the cell at
another size, its columns' distinct counts scaled alike (a witness where
the program and the reference should agree).  The benchmark's own runs do
not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import compare, faults, harness, reference
    from perfbench.spec import load_cell

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if args.rows:
        scale = args.rows / cell.rows
        cell = cell.resized(args.rows, **{
            c: {"distinct": round(spec["distinct"] * scale)}
            for c, spec in cell.config["columns"].items() if "distinct" in spec})
    device = torch.device("cuda", 0)
    program = harness.Program(cell, device)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def emit(kind, seed, reading, t0, ref):
        print(json.dumps({"cell": cell.name, "rows": cell.rows, "kind": kind, "seed": seed,
                          "reading": reading, "largest_group": int(ref["count"].max()),
                          "seconds": time.perf_counter() - t0}), flush=True)

    def program_reading(seed):
        cols = harness.make_columns(cell, seed, device)
        program.query(cols)
        results = [harness.result_map(program.query(cols)[0])
                   for _ in harness.kept_queries(seed)]
        ref = reference.groupby(cols[cell.key], cols, cell.aggs)
        return compare.worst(compare.compare(r, n, ref, cell.aggs) for r, n in results), ref

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        reading, ref = program_reading(seed)
        emit("program", seed, reading, t0, ref)
        del ref
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        cols = harness.make_columns(cell, seed, device)
        ref = reference.groupby(cols[cell.key], cols, cell.aggs)
        ctl = reference.groupby_control(cols[cell.key], cols, cell.aggs)
        emit("control", seed, compare.compare(ctl, ctl["__num_groups__"], ref, cell.aggs), t0, ref)
        del cols, ref, ctl
        torch.cuda.empty_cache()
    if args.fault:
        with faults.FAULTS[args.fault]():
            for seed in seeds(args.fault_seeds):
                t0 = time.perf_counter()
                reading, ref = program_reading(seed)
                emit(args.fault, seed, reading, t0, ref)
                del ref
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
