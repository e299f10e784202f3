"""The mesh seam: a single-controller device mesh and its collectives.

Port of the GROUP BY half of ``repro.parallel.sharding`` (its ``shard_map``
seam; the LM placement rules wait for the LM stack).  The reference runs
one Python process that holds a ``jax.sharding.Mesh`` and ``shard_map``\\ s
each chunk over it; the port keeps that model.  A :class:`Mesh` is a numpy
array of :class:`MeshDevice` members, each a ``torch.device`` with an id.
One process drives every member: a member's state is a set of tensors on
its device, and the only moves of data between members are the
collectives below, each a ``Tensor.to(member.device)``.

Members may share one physical device: :func:`virtual_devices` makes
:func:`devices` return ``n`` members on one device, the counterpart of the
reference tests' ``--xla_force_host_platform_device_count`` (on the CPU
here, on the one card of a one-card machine).  Such members are still
distinct, each with its own tensors; a collective between them copies
nothing where ``.to()`` has nothing to move, and clones where the result
must not share storage with a member's live state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class MeshDevice:
    """One member of a mesh: ``id`` (what ``train.elastic.mark_failed``
    records, as a JAX device's ``.id``) and the ``torch.device`` its
    tensors live on.  Not a tuple, so that ``np.asarray`` of members is a
    1-D object array, as of JAX devices."""

    id: int
    device: torch.device


class Mesh:
    """The part of ``jax.sharding.Mesh`` the engine uses: ``devices`` (a
    numpy object array of :class:`MeshDevice`), ``axis_names``, ``shape``
    (axis name → size) and ``size``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes {axis_names}")
        if not all(isinstance(d, MeshDevice) for d in arr.reshape(-1)):
            raise TypeError("a mesh holds MeshDevice members")
        ids = [d.id for d in arr.reshape(-1)]
        if len(set(ids)) != len(ids):
            raise ValueError(f"a mesh member repeats: ids {ids}")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def members(self, axis: str) -> list:
        """The members along ``axis`` (index 0 of every other axis): the
        ones a computation sharded over ``axis`` runs on."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[d.id for d in self.devices.reshape(-1)]})"


_VIRTUAL: tuple | None = None  # (count, device) set by virtual_devices


def _device_of(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (None: the current
    card); CUDA raises where no card exists (the port's device rule)."""
    from repro_torch.engine.groupby import resolve_device

    dev = resolve_device(None if device is None else str(device))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class virtual_devices:
    """Make :func:`devices` return ``n`` members on ``device``: a CUDA
    device by default (the current card; raises where there is none, as
    the port's other entry points do), or ``"cpu"`` when asked for.
    Takes effect when called; as a context manager it restores the
    previous setting on exit, and :func:`reset_virtual_devices` drops it."""

    def __init__(self, n: int, device=None):
        global _VIRTUAL
        if n < 1:
            raise ValueError(f"virtual_devices needs n >= 1, got {n}")
        self._previous = _VIRTUAL
        _VIRTUAL = (int(n), _device_of(device))

    def __enter__(self) -> list:
        return devices()

    def __exit__(self, *exc) -> None:
        global _VIRTUAL
        _VIRTUAL = self._previous


def reset_virtual_devices() -> None:
    global _VIRTUAL
    _VIRTUAL = None


def devices() -> list:
    """The counterpart of ``jax.devices()``: the members set by
    :func:`virtual_devices`, else one per visible CUDA card (raises where
    there is none: members on the CPU need ``virtual_devices(n, "cpu")``)."""
    return _visible_devices()


def _visible_devices() -> list:
    if _VIRTUAL is not None:
        n, dev = _VIRTUAL
        return [MeshDevice(i, dev) for i in range(n)]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "devices() lists CUDA cards and there is none; members on the CPU "
            "need virtual_devices(n, 'cpu')"
        )
    return [MeshDevice(i, torch.device("cuda", i)) for i in range(n)]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], devices=None) -> Mesh:
    """The counterpart of ``jax.make_mesh``: the first ``prod(shape)``
    members of ``devices`` (default :func:`devices`) in a mesh of
    ``shape``."""
    shape = tuple(int(s) for s in shape)
    pool = list(_visible_devices() if devices is None else devices)
    need = math.prod(shape)
    if len(pool) < need:
        raise ValueError(f"a mesh of shape {shape} needs {need} devices, {len(pool)} given")
    arr = np.empty((need,), dtype=object)
    for i, d in enumerate(pool[:need]):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)


# ---------------------------------------------------------------------------
# collectives over per-member tensors (member i's tensor on members[i])


def shard(x: torch.Tensor, members: Sequence[MeshDevice]) -> list:
    """Split ``x`` along dim 0 into one contiguous part per member, each
    put on its member's device (the reference's ``device_put`` with
    ``P(axis)``); dim 0 must divide evenly."""
    n = len(members)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} members")
    return [p.to(m.device) for p, m in zip(x.tensor_split(n), members)]


def all_gather(tensors: Sequence[torch.Tensor], members: Sequence[MeshDevice]) -> list:
    """Tiled all-gather: every member gets the members' tensors
    concatenated along dim 0, in member order (a fresh tensor each)."""
    return [torch.cat([t.to(m.device) for t in tensors]) for m in members]


def gather(tensors: Sequence[torch.Tensor], dst: MeshDevice) -> torch.Tensor:
    """The tiled concatenation of the members' tensors on one member."""
    return torch.cat([t.to(dst.device) for t in tensors])


def _reduce(tensors, dst: MeshDevice, op) -> torch.Tensor:
    out = tensors[0].to(dst.device, copy=True)  # never a member's own storage
    for t in tensors[1:]:
        op(out, t.to(dst.device), out=out)
    return out


def psum(tensors: Sequence[torch.Tensor], dst: MeshDevice) -> torch.Tensor:
    """The elementwise sum of the members' tensors, on ``dst``."""
    return _reduce(tensors, dst, torch.add)


def pmin(tensors: Sequence[torch.Tensor], dst: MeshDevice) -> torch.Tensor:
    return _reduce(tensors, dst, torch.minimum)


def pmax(tensors: Sequence[torch.Tensor], dst: MeshDevice) -> torch.Tensor:
    return _reduce(tensors, dst, torch.maximum)


def all_to_all(buckets: Sequence[torch.Tensor], members: Sequence[MeshDevice]) -> list:
    """``buckets[i]`` is member i's ``(ndev, ...)`` tensor whose row j goes
    to member j; member j gets ``(ndev, ...)``, row i from member i (the
    reference's untiled ``all_to_all`` with split and concat axis 0)."""
    n = len(members)
    for b in buckets:
        if b.shape[0] != n:
            raise ValueError(f"a bucket tensor of {b.shape[0]} rows for {n} members")
    return [torch.stack([b[j].to(m.device) for b in buckets]) for j, m in enumerate(members)]


__all__ = [
    "Mesh",
    "MeshDevice",
    "all_gather",
    "all_to_all",
    "devices",
    "gather",
    "make_mesh",
    "pmax",
    "pmin",
    "psum",
    "reset_virtual_devices",
    "shard",
    "virtual_devices",
]
