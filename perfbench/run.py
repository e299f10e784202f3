"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card and its power limit first, each compared number beside its
limit as the last lines of standard error, and one JSON object as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` a ``breakdown``, and ``checks`` last.
Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), without the program, or if JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read (exit {out.returncode})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    from perfbench.spec import load_cell

    t_torch = time.perf_counter()
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    torch.empty(1, device=device)
    t_card = time.perf_counter()
    print(f"perfbench: {cell.name} seed {args.seed} on {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                       stages=f"torch {t_torch - T_START:.3f}, card {t_card - t_torch:.3f}, ")
    # read after the window, so that set-up does not pay for it
    print(f"perfbench: card and power limit: {power_limit()}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that must not be: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        c["value"] = c["value"] if math.isfinite(c["value"]) else str(c["value"])
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
