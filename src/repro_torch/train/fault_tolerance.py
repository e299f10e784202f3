"""Fault tolerance and straggler mitigation, host-side runtime policy
(port of ``repro.train.fault_tolerance``; it touches no device).

* :class:`ElasticRunner` wraps a training body: when the body raises
  ``train.elastic.WorkerFailure``, the runner marks the failed members,
  rebuilds the mesh from the members still available (``make_mesh`` of
  ``elastic.available_devices()``) and runs the body again, which restores
  from the checkpoint manager's last commit; at most ``max_restarts``
  times, then the failure propagates.
* :class:`StragglerPolicy` records per-step wall times and flags a step
  slower than ``threshold`` × the median of the window before it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.train import elastic


@dataclass
class StragglerPolicy:
    threshold: float = 2.0
    window: int = 16
    times: list = field(default_factory=list)
    flagged: int = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step straggled."""
        self.times.append(seconds)
        hist = self.times[-self.window:]
        if len(hist) < 4:
            return False
        med = float(np.median(hist[:-1]))
        if seconds > self.threshold * med:
            self.flagged += 1
            return True
        return False


class ElasticRunner:
    """Restart-on-failure wrapper around a step-loop body."""

    def __init__(self, make_mesh, checkpoint_manager, *, max_restarts: int = 3):
        self.make_mesh = make_mesh
        self.ckpt = checkpoint_manager
        self.max_restarts = max_restarts
        self.restarts = 0
        self.straggler = StragglerPolicy()

    def run(self, build_and_train):
        """``build_and_train(mesh, straggler) -> result``, run on a mesh of
        the available members and again after each ``WorkerFailure``."""
        while True:
            mesh = self.make_mesh(elastic.available_devices())
            try:
                return build_and_train(mesh, self.straggler)
            except elastic.WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                elastic.mark_failed(e.device_ids)
                print(
                    f"[elastic] worker failure ({e.device_ids}); restart "
                    f"{self.restarts}/{self.max_restarts} on "
                    f"{len(elastic.available_devices())} devices",
                    flush=True,
                )


__all__ = ["ElasticRunner", "StragglerPolicy"]
