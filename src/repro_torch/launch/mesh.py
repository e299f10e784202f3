"""Meshes over the port's members (port of ``repro.launch.mesh``).

Functions, so importing this module touches no device.  Both build a
``parallel.sharding.Mesh`` over ``sharding.devices()`` (the visible CUDA
cards, or the members set with ``virtual_devices``; with neither,
``devices()`` raises ``RuntimeError``).

Single pod: (data=16, model=16), 256 members.
Multi-pod:  (pod=2, data=16, model=16), 512 members; the ``pod`` axis
carries data parallelism only (the gradient mean, int8-compressible).
A mesh needs that many members and raises ``ValueError`` where there are
fewer, as ``make_mesh`` does.
"""
from __future__ import annotations

from repro_torch.parallel import sharding


def make_production_mesh(*, multi_pod: bool = False) -> sharding.Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return sharding.make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> sharding.Mesh:
    """A small (data, model) mesh over the first data × model members."""
    return sharding.make_mesh((data, model), ("data", "model"))


__all__ = ["make_host_mesh", "make_production_mesh"]
