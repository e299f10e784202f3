"""Training launcher CLI (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \
      --batch 8 --seq 128 --steps 100 [--reduced] [--elastic]

Runs ``train.loop.train_loop`` on the largest (data, model) mesh of
``parallel.sharding.devices()`` with a model axis of ``--model-parallel``:
the visible cards, or the members a caller set with ``virtual_devices``
(with neither it raises ``RuntimeError``; there is no CPU fallback).  The
data is ``SyntheticLM`` on the first member's device; commits go through
the port's ``CheckpointManager`` every ``--ckpt-every`` steps, and a run
resumes from the directory's latest commit.  ``--elastic`` runs the loop
under ``ElasticRunner``, which rebuilds the mesh from the members left
after a ``WorkerFailure`` and restores from the last commit.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.parallel import sharding
from repro_torch.train import elastic
from repro_torch.train.fault_tolerance import ElasticRunner
from repro_torch.train.loop import TrainHParams, train_loop


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and train; returns
    ``train_loop``'s ``(params, opt_state, metrics_hist)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=ARCH_IDS + [a.replace("_", "-") for a in ARCH_IDS])
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-ticketed-embedding", action="store_true")
    ap.add_argument("--elastic", action="store_true")
    args = ap.parse_args(argv)

    members = sharding.devices()
    cfg = get_config(args.arch, reduced=args.reduced)
    hp = TrainHParams(
        peak_lr=args.lr,
        warmup=min(20, args.steps // 10 + 1),
        total_steps=args.steps,
        ticketed_embedding=not args.no_ticketed_embedding,
    )
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, device=members[0].device)

    def build_and_train(mesh, straggler):
        return train_loop(
            mesh, cfg, hp, iter(data), steps=args.steps,
            checkpoint_manager=mgr, checkpoint_every=args.ckpt_every,
        )

    if args.elastic:
        runner = ElasticRunner(
            lambda devs: elastic.largest_mesh(devs, args.model_parallel), mgr
        )
        out = runner.run(build_and_train)
    else:
        out = build_and_train(elastic.largest_mesh(members, args.model_parallel), None)
    mgr.wait()
    return out


if __name__ == "__main__":
    main()
