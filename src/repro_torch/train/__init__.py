"""Training (port of ``repro.train``): the steps and the loop on a mesh
(``loop``), restart and straggler policy (``fault_tolerance``), and
worker-failure bookkeeping and re-meshing (``elastic``)."""
from repro_torch.train.elastic import (
    WorkerFailure,
    available_devices,
    failed_ids,
    largest_mesh,
    mark_failed,
    remesh,
    reset_failures,
    reshard_restore,
)
from repro_torch.train.fault_tolerance import ElasticRunner, StragglerPolicy
from repro_torch.train.loop import (
    TrainHParams,
    jit_train_step,
    make_loss_fn,
    make_manual_dp_step,
    make_train_step,
    train_loop,
)

__all__ = [
    "ElasticRunner",
    "StragglerPolicy",
    "TrainHParams",
    "WorkerFailure",
    "available_devices",
    "failed_ids",
    "jit_train_step",
    "largest_mesh",
    "make_loss_fn",
    "make_manual_dp_step",
    "make_train_step",
    "mark_failed",
    "remesh",
    "reset_failures",
    "reshard_restore",
    "train_loop",
]
