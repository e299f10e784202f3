#!/usr/bin/env python3
"""Phase-4 kernel times of one source tree, for comparing two trees on one
card.

    python3 tools/kernel_turns.py SRC_DIR

Times three kernels on ``chip_smoke.py``'s phase-4 chunks (seed 0: one
2^21-row main-path chunk per class, with the bound of the class's stream)
with its own helpers, importing ``repro_torch`` from ``SRC_DIR``: the fused
kernel at P = 1 (``kernel_timing``), the ticket kernel, and
``scan_ticket`` (4096-row morsels, the table reset before each call).
Each is timed three times per class in one process (CUDA events, median
of 5 after 50 ms of warm-up calls), and the script prints ``SRC_DIR
{kernel: {class: [ms, ...]}}``.  To compare a parent tree with the
working tree on one card, unpack the parent into an ignored directory and
run them in turns (from the repository root):

    git archive PARENT src | tar -x -C build/parent
    for t in build/parent/src src src build/parent/src; do
        python3 tools/kernel_turns.py $t | tail -1; done
"""
import json
import os
import sys

SRC = os.path.abspath(sys.argv[1])
sys.path.insert(0, SRC)
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import ticketing as tk  # noqa: E402
from repro_torch.core.hashing import table_capacity  # noqa: E402
from repro_torch.kernels import fused_groupby as fk  # noqa: E402
from repro_torch.kernels import ticket_hash as th  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    classes, vals = cs.phase4_chunks(torch.Generator(device=dev).manual_seed(0), dev)
    out = {"fused_groupby": {}, "ticket_hash": {}, "scan_ticket": {}}
    for _ in range(3):
        for name, (keys, g) in classes.items():
            ms, _ = cs.kernel_timing(fk, keys, vals, max_groups=g, programs=1, device=dev)
            out["fused_groupby"].setdefault(name, []).append(ms)
            k32 = keys.to(torch.int32)
            kw = dict(capacity=table_capacity(g), max_groups=g, morsel_size=cs.M)
            ms = cs.time_cuda(lambda: th.ticket_hash(k32, **kw), 5)
            out["ticket_hash"].setdefault(name, []).append(ms)
            km, _, work, todo, skw, reset = cs.scan_launch(fk, tk, k32, g, dev)
            ms = cs.time_cuda(lambda: fk.scan_ticket(work, km, todo, **skw), 5, reset)
            out["scan_ticket"].setdefault(name, []).append(ms)
            del work
    print(sys.argv[1], json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
