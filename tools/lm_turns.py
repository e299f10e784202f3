#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 3 lm (granite-moe-1b-a400m served at full
width) for one source tree, for comparing two trees' decode steps on one
card.

    python3 tools/lm_turns.py SRC_DIR [RUNS]

Imports ``repro_torch`` from ``SRC_DIR`` and runs ``chip_smoke.phase3_lm``
``RUNS`` times (default 2) in one process, with all of its checks (launch
counts, forward vs decode, the MoE block through the kernels vs the plain
versions); the first run of a process pays the kernel builds and first
allocations.  Prints ``SRC_DIR {"decode_ms_per_step": [...], "prefill_s":
[...]}``.  The decode step is host-bound, so compare trees only in turns
on one card (from the repository root):

    git archive PARENT src | tar -x -C build/parent
    for t in build/parent/src src src build/parent/src; do
        python3 tools/lm_turns.py $t | tail -1; done
"""
import json
import os
import sys

SRC = os.path.abspath(sys.argv[1])
sys.path.insert(0, SRC)
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_turns: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import fused_groupby as fk
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import hybrid_registers as hr
    from repro_torch.kernels import preagg as pa
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.kernels import ticket_hash as th

    # chip_smoke.main's name → (module, wrapper) whose ``launches`` counts that kernel
    kmods = {"fused_groupby": (fk, "fused_consume"), "ticket_hash": (th, "ticket_hash"),
             "segment_agg": (sa, "segment_agg"), "scan_ticket": (fk, "scan_ticket"),
             "scan_ticket_batched": (fk, "scan_ticket_batched"),
             "segment_agg_serialized": (sa, "serialized_agg"),
             "hybrid_registers": (hr, "hybrid_registers"), "preagg": (pa, "preagg"),
             "grouped_matmul": (gm, "grouped_matmul"), "segment_rows": (sr, "segment_rows")}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    out = {"decode_ms_per_step": [], "prefill_s": []}
    for _ in range(runs):
        rec = cs.phase3_lm(kmods, device, seed=0)
        out["decode_ms_per_step"].append(rec["decode_ms_per_step"])
        out["prefill_s"].append(rec["prefill_s"])
    print(sys.argv[1], json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
