"""Serving launcher CLI (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b --reduced \
      --requests 8 --max-new 16

Serves random-weight requests through ``serve.engine.ServeLoop`` on a
(data = all members, model = 1) mesh of ``parallel.sharding.devices()``:
the visible cards, or the members a caller set with ``virtual_devices``
(with neither it raises ``RuntimeError``; there is no CPU fallback).
Parameters are drawn from a generator seeded 0 on the first member's
device, prompts from a ``torch.Generator`` seeded 1; ``--slots`` requests
a batch.  Prints ``served N requests, T tokens in Xs (R tok/s)``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding
from repro_torch.serve.engine import Request, ServeLoop


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and serve; returns the
    served requests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    members = sharding.devices()
    dev = members[0].device
    cfg = get_config(args.arch, reduced=args.reduced)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    mesh = sharding.make_mesh((len(members), 1), ("data", "model"), devices=members)
    loop = ServeLoop(mesh, cfg, params, slots=args.slots, max_len=args.max_len)

    gen = torch.Generator().manual_seed(1)
    pending = [
        Request(uid=i,
                prompt=torch.randint(0, cfg.vocab_size, (args.prompt_len,), generator=gen,
                                     dtype=torch.int32),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    served = []
    t0 = time.time()
    while pending:
        batch, pending = pending[: args.slots], pending[args.slots:]
        served += loop.run_batch(batch)
    dt = time.time() - t0
    total_new = sum(len(r.generated) for r in served)
    print(f"served {len(served)} requests, {total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s)")
    return served


if __name__ == "__main__":
    main()
