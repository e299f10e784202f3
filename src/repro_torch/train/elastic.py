"""Elastic re-meshing: the survivor mesh after a loss, and worker-failure
bookkeeping (port of the device part of ``repro.train.elastic``).

``mark_failed`` records member ids as lost.  :func:`available_devices` is
``parallel.sharding.devices()`` less them, and :func:`largest_mesh` builds
the largest ``(data, model)`` mesh over a device list with the model axis
kept (the DATA axis absorbs the loss).  A sharded stream re-meshes onto
its survivors in place (``engine/elastic.py`` ``remesh_stream``); the
serving layer (``serve/query_server.py``) lets a quantum that raises
:class:`WorkerFailure` restore from its stream's last checkpoint, or
propagate when there is none.  :func:`reshard_restore` restores an LM
training commit placed by the parameters' placement rules on a new mesh,
the survivors' after a loss: commits hold whole host arrays, so any mesh
whose ``model`` axis divides the parameters takes them.
"""
from __future__ import annotations

from dataclasses import dataclass

_failed: set[int] = set()


@dataclass
class WorkerFailure(Exception):
    device_ids: list


def mark_failed(device_ids) -> None:
    _failed.update(device_ids)


def reset_failures() -> None:
    _failed.clear()


def failed_ids() -> frozenset:
    """The device ids currently marked failed (the engine's elastic streams
    read this to detect loss on a query mesh)."""
    return frozenset(_failed)


def available_devices() -> list:
    """The mesh members of ``parallel.sharding.devices()`` not marked
    failed."""
    from repro_torch.parallel.sharding import devices

    return [d for d in devices() if d.id not in _failed]


def largest_mesh(devices, model_parallel: int):
    """Largest ``(data, model)`` mesh over ``devices`` with a fixed model
    axis: the data axis takes ``len(devices) // model_parallel``."""
    from repro_torch.parallel.sharding import make_mesh

    n = len(devices)
    if n < model_parallel:
        raise ValueError(f"{n} devices for a model axis of {model_parallel}")
    data = n // model_parallel
    return make_mesh((data, model_parallel), ("data", "model"), devices=devices)


def remesh(model_parallel: int):
    return largest_mesh(available_devices(), model_parallel)


def reshard_restore(ckpt_manager, params_template, opt_template, mesh):
    """The latest commit of ``ckpt_manager`` with its parameters placed on
    ``mesh`` by ``param_shardings`` (``(params, opt, step)``; ``opt`` as
    host tensors, as the reference returns it; None without a commit)."""
    from repro_torch.parallel.sharding import param_shardings

    return ckpt_manager.restore_latest(
        params_template, opt_template, shardings=param_shardings(mesh, params_template))


__all__ = ["WorkerFailure", "available_devices", "failed_ids", "largest_mesh",
           "mark_failed", "remesh", "reset_failures", "reshard_restore"]
