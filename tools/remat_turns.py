#!/usr/bin/env python3
"""What per-layer remat costs the training steps, on one card: the steps
of ``chip_smoke.py``'s phase 3 train (qwen3-0.6b) and train_moe
(granite-moe-1b-a400m) at full width, 8 × 128 tokens, with every block
rematerialised (``transformer._remat``) and with the blocks called
directly, in turns in one process.

    python3 tools/remat_turns.py [STEPS]

Each turn is ``chip_smoke.run_train_loop`` (``train_loop`` over
``SyntheticLM``, TRAIN_HP, ticketed embedding) for STEPS steps (default
16); the turns run direct, remat, remat, direct for each config, and the
first turn of the process pays its first allocations and imports.  For
the direct turns ``transformer._remat`` is swapped for a wrapper that
returns the block (the package has no such switch).  Prints one line a
turn and, last, ``remat_turns {...}``: each config's median ms a step
(the first step left out) and peak MiB by turn, with the card's name and
power limit.
"""
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("remat_turns: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_groupby as fk
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.kernels import ticket_hash as th
    from repro_torch.models import transformer as tf

    kmods = {"ticket_hash": (th, "ticket_hash"), "segment_agg": (sa, "segment_agg"),
             "scan_ticket": (fk, "scan_ticket"), "grouped_matmul": (gm, "grouped_matmul"),
             "grouped_matmul_backward": (gm, "grouped_matmul_backward"),
             "segment_rows": (sr, "segment_rows")}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.TRAIN_STEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    out = {}
    for arch in (cs.TRAIN_ARCH, cs.MOE_TRAIN_ARCH):
        cfg = get_config(arch)
        for turn in ("direct", "remat", "remat", "direct"):
            with cs.direct_blocks(tf) if turn == "direct" else contextlib.nullcontext():
                run = cs.run_train_loop(kmods, cfg, device, 0, f"{arch} {turn}")
            rec = run["rec"]
            del run
            torch.cuda.empty_cache()
            row = out.setdefault(arch, {"direct": [], "remat": []})[turn]
            row.append({"step_ms": rec["step_ms"], "peak_over_held_mib": rec["peak_over_held_mib"],
                        "launches": {k: v for k, v in rec["launches"].items() if v}})
            cs.log(f"remat_turns {arch} {turn}: {rec['step_ms']:.2f} ms a step (median of "
                   f"{cs.TRAIN_STEPS - 2}), peak {rec['peak_over_held_mib']:.0f} MiB over what was "
                   f"held; launches {row[-1]['launches']}")
    out["card"] = cs.card_line()
    print("remat_turns " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
