"""The mesh seam: a single-controller device mesh and its collectives.

Port of ``repro.parallel.sharding``: its ``shard_map`` seam, its
data-parallel axes (``dp_axes``, ``batch_spec``) and its LM placement rules
(``spec_for_path``, ``param_specs``, ``param_shardings``); the cache rules
(``cache_specs``) wait for serving over members, ROADMAP item 10c2c.  The
reference runs one Python process that holds a ``jax.sharding.Mesh`` and
``shard_map``\\ s each chunk over it; the port keeps that model.  A
:class:`Mesh` is a numpy array of :class:`MeshDevice` members, each a
``torch.device`` with an id.  One process drives every member: a member's
state is a set of tensors on its device, and the only moves of data
between members are the collectives below, each a
``Tensor.to(member.device)``.

Members may share one physical device: :func:`virtual_devices` makes
:func:`devices` return ``n`` members on one device, the counterpart of the
reference tests' ``--xla_force_host_platform_device_count`` (on the CPU
here, on the one card of a one-card machine).  Such members are still
distinct, each with its own tensors; a collective between them copies
nothing where ``.to()`` has nothing to move, and clones where the result
must not share storage with a member's live state.

Placement (:func:`place`, the counterpart of ``jax.device_put(tree,
shardings)``) turns each tensor leaf into a :class:`PlacedTensor`: the parts
that a :class:`NamedSharding` names, ONE tensor per (device, part index).
Virtual members on one device that hold the same part share that tensor,
so a (data 2, model 2) mesh of one card holds a vocab-sharded table once,
not twice.  A spec is the tuple of its entries (None, an axis name, or a
tuple of axis names), the form :func:`batch_spec` returns.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Sequence

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


def dp_axes(mesh: Mesh) -> tuple:
    """Data-parallel mesh axes: ``("pod", "data")`` on a mesh with a pod
    axis, ``("data",)`` otherwise (the reference's ``dp_axes``)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_spec(mesh: Mesh) -> tuple:
    """The reference's ``batch_spec``, ``P(dp_axes(mesh), None)``, as the
    tuple of its entries (a lone axis name unwrapped, as ``P`` keeps it): a
    batch's dim 0 split over the data-parallel axes in member order, dim 1
    whole."""
    dp = dp_axes(mesh)
    return (dp if len(dp) > 1 else dp[0], None)


# ---------------------------------------------------------------------------
# LM parameter placement (the reference's _RULES, spec_for_path, param_specs,
# param_shardings) and jax.device_put's counterpart

M = "model"

# ordered (regex over '/'-joined path, base spec for the *trailing* dims)
_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$", (M, None)),
    (r"lm_head/w$", (None, M)),
    (r"frontend_proj/w$", (None, None)),
    # attention
    (r"attn/wq/w$", (None, M)),
    (r"attn/wk/w$", (None, M)),
    (r"attn/wv/w$", (None, M)),
    (r"attn/w[qkv]/b$", (M,)),
    (r"attn/wo/w$", (M, None)),
    (r"attn/[qk]_norm/scale$", (None,)),
    (r"cross/wq/w$", (None, M)),
    (r"cross/wk/w$", (None, M)),
    (r"cross/wv/w$", (None, M)),
    (r"cross/w[qkv]/b$", (M,)),
    (r"cross/wo/w$", (M, None)),
    # dense mlp
    (r"mlp/w_gate/w$", (None, M)),
    (r"mlp/w_up/w$", (None, M)),
    (r"mlp/w_down/w$", (M, None)),
    # moe: experts sharded over 'model'
    (r"moe/router/w$", (None, None)),
    (r"moe/w_gate$", (M, None, None)),
    (r"moe/w_up$", (M, None, None)),
    (r"moe/w_down$", (M, None, None)),
    (r"moe/shared/w_gate/w$", (None, M)),
    (r"moe/shared/w_up/w$", (None, M)),
    (r"moe/shared/w_down/w$", (M, None)),
    (r"moe/shared_gate/w$", (None, None)),
    # mamba2
    (r"mamba/in_z/w$", (None, M)),
    (r"mamba/in_x/w$", (None, M)),
    (r"mamba/in_B/w$", (None, None)),
    (r"mamba/in_C/w$", (None, None)),
    (r"mamba/in_dt/w$", (None, M)),
    (r"mamba/conv_x$", (None, M)),
    (r"mamba/conv_x_b$", (M,)),
    (r"mamba/conv_[BC]$", (None, None)),
    (r"mamba/conv_[BC]_b$", (None,)),
    (r"mamba/A_log$", (M,)),
    (r"mamba/D$", (M,)),
    (r"mamba/dt_bias$", (M,)),
    (r"mamba/norm/scale$", (M,)),
    (r"mamba/out_proj/w$", (M, None)),
    # rwkv6
    (r"time/w[rkvg]/w$", (None, M)),
    (r"time/wo/w$", (M, None)),
    (r"time/wA/w$", (None, None)),
    (r"time/wB/w$", (None, M)),
    (r"time/w0$", (M,)),
    (r"time/u$", (M, None)),
    (r"time/mix_\w+$", (None,)),
    (r"time/ln_x/scale$", (M,)),
    (r"time/wk_c/w$", (None, M)),
    (r"time/wv_c/w$", (M, None)),
    (r"time/wr_c/w$", (None, None)),
    # norms and anything else: replicated
    (r".*", ()),
]


def spec_for_path(path: str, ndim: int, shape=None) -> tuple:
    """The spec of the leaf at ``path`` (dict keys joined by ``/``): the
    first rule that matches, right-aligned to ``ndim`` (left-padded with
    None for stacked-layer axes); a size-1 dim never shards."""
    # int8-quantized kernels reuse the fp kernel's rule
    path = path.replace("/w_q8", "/w").replace("/w_scale", "/w")
    for pat, base in _RULES:
        if re.search(pat, path):
            spec = list(base)
            if len(spec) > ndim:  # scalar params matched by a vector rule
                spec = spec[-ndim:] if ndim else []
            spec = [None] * (ndim - len(spec)) + spec
            if shape is not None:
                spec = [a if shape[i] != 1 else None for i, a in enumerate(spec)]
            return tuple(spec)
    return ()


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and tuples
    (NamedTuples by field name), ``path`` the keys joined by ``/``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest), path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
        vals = [_map_with_path(fn, *xs, path=path + (str(n),))
                for n, xs in zip(names, zip(tree, *rest))]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn("/".join(path), tree, *rest)


def param_specs(params: Any) -> Any:
    """The spec tree matching ``params``: each leaf's spec by
    :func:`spec_for_path` as a plain tuple (``tuple(P)`` of the
    reference's).  Leaves are tensors or :class:`PlacedTensor`\\ s."""
    return _map_with_path(
        lambda path, leaf: spec_for_path(path, len(leaf.shape), tuple(leaf.shape)),
        params)


class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec (a tuple with one
    entry per leading dim: None, an axis name or a tuple of axis names;
    dims past the spec are whole)."""

    def __init__(self, mesh: Mesh, spec: Sequence = ()):
        spec = tuple(tuple(a) if isinstance(a, list) else a for a in spec)
        used = [a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))]
        for a in used:
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of {mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} names an axis twice")
        self.mesh = mesh
        self.spec = spec

    def _axes(self, i: int) -> tuple:
        e = self.spec[i] if i < len(self.spec) else None
        return () if e is None else (e if isinstance(e, tuple) else (e,))

    def parts(self, i: int) -> int:
        """How many parts dim ``i`` is split into."""
        return math.prod(self.mesh.shape[a] for a in self._axes(i))

    def shard_shape(self, shape) -> tuple:
        return tuple(n // self.parts(i) for i, n in enumerate(shape))

    def index_of(self, coord: tuple, ndim: int) -> tuple:
        """The part index, dim by dim, of the member at mesh coordinate
        ``coord``: row-major over the axes a dim's entry names."""
        out = []
        for i in range(ndim):
            k = 0
            for a in self._axes(i):
                j = self.mesh.axis_names.index(a)
                k = k * self.mesh.devices.shape[j] + coord[j]
            out.append(k)
        return tuple(out)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.spec == other.spec
                and (self.mesh is other.mesh or (
                    self.mesh.axis_names == other.mesh.axis_names
                    and self.mesh.devices.shape == other.mesh.devices.shape
                    and all(a == b for a, b in zip(self.mesh.devices.reshape(-1),
                                                   other.mesh.devices.reshape(-1))))))

    __hash__ = None

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, spec={self.spec})"


def param_shardings(mesh: Mesh, params: Any) -> Any:
    """A :class:`NamedSharding` over ``mesh`` for each leaf of ``params``,
    by :func:`param_specs`."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, spec_for_path(path, len(leaf.shape), tuple(leaf.shape))),
        params)


def _dev_key(dev: torch.device) -> str:
    return str(dev)


def _slices(index: tuple, part_shape: tuple) -> tuple:
    return tuple(slice(k * n, (k + 1) * n) for k, n in zip(index, part_shape))


class PlacedTensor:
    """A tensor placed over a mesh (a leaf of :func:`place`'s result):
    ``sharding``, the global ``shape`` and ``dtype``, and ``copies``, ONE
    tensor per (device, part index), shaped ``sharding.shard_shape``.
    Members on one device that hold the same part read the same tensor
    (:meth:`shard`).  The step writes copies in place."""

    def __init__(self, sharding: NamedSharding, shape, dtype, copies: dict):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.copies = copies      # (device str, part index) → tensor

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def shard(self, coord: tuple) -> torch.Tensor:
        """The part held by the member at mesh coordinate ``coord``."""
        dev = self.sharding.mesh.devices[coord].device
        return self.copies[(_dev_key(dev), self.sharding.index_of(coord, self.ndim))]

    def part_slices(self, index: tuple) -> tuple:
        """Where part ``index`` sits in the global tensor."""
        return _slices(index, self.sharding.shard_shape(self.shape))

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first member's), a
        fresh tensor assembled from one copy of each part."""
        mesh = self.sharding.mesh
        dev = mesh.devices.reshape(-1)[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for (_, index), t in sorted(self.copies.items(), key=lambda kv: kv[0][0] != str(dev)):
            if index not in done:
                out[self.part_slices(index)] = t.detach().to(dev)
                done.add(index)
        return out

    def gathered(self, device) -> torch.Tensor:
        """The whole tensor on ``device`` for a computation to read: the
        copy there where one copy is the whole tensor (its storage: do not
        write it), else :meth:`full`."""
        if all(self.sharding.parts(i) == 1 for i in range(self.ndim)):
            t = self.copies.get((_dev_key(torch.device(device)), (0,) * self.ndim))
            if t is not None:
                return t
        return self.full(device)

    def map(self, fn) -> "PlacedTensor":
        """A PlacedTensor of the same sharding with ``fn`` of each copy
        (``fn`` keeps shapes)."""
        copies = {k: fn(t) for k, t in self.copies.items()}
        t0 = next(iter(copies.values()))
        return PlacedTensor(self.sharding, self.shape, t0.dtype, copies)

    def __repr__(self) -> str:
        return (f"PlacedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, copies={len(self.copies)})")


def _check_devices(mesh: Mesh) -> None:
    """The port's device rule for every device of ``mesh`` (a CUDA member
    where no card exists raises ``RuntimeError``), before anything moves."""
    from repro_torch.engine.groupby import resolve_device

    for dev in {_dev_key(m.device) for m in mesh.devices.reshape(-1)}:
        resolve_device(dev)


def place_leaf(x, sharding: NamedSharding, path: str = "") -> PlacedTensor:
    """One leaf placed by ``sharding`` (see :func:`place`)."""
    if isinstance(x, PlacedTensor):
        if x.sharding == sharding:
            return x
        x = x.full()
    x = torch.as_tensor(x).detach()
    shape = tuple(x.shape)
    if len(sharding.spec) > len(shape):
        raise ValueError(f"{path}: spec {sharding.spec} for a rank-{len(shape)} leaf")
    for i, n in enumerate(shape):
        k = sharding.parts(i)
        if n % k:
            raise ValueError(
                f"{path}: {sharding!r} splits dim {i} into {k} parts, which {n} does not "
                f"divide (shape {shape})")
    _check_devices(sharding.mesh)
    part_shape = sharding.shard_shape(shape)
    copies = {}
    for coord in np.ndindex(*sharding.mesh.devices.shape):
        dev = sharding.mesh.devices[coord].device
        index = sharding.index_of(coord, len(shape))
        key = (_dev_key(dev), index)
        if key not in copies:
            copies[key] = x[_slices(index, part_shape)].to(
                dev, copy=True, memory_format=torch.contiguous_format)
    return PlacedTensor(sharding, shape, x.dtype, copies)


def place(tree: Any, shardings: Any) -> Any:
    """The counterpart of ``jax.device_put(tree, shardings)``: each leaf as
    a :class:`PlacedTensor` by its :class:`NamedSharding` (``shardings`` a
    tree of the same structure, or one sharding for every leaf).  Member
    (…, model k, …) holds part k of each dim whose spec entry names
    ``model``, contiguous parts split as ``NamedSharding`` splits them; a
    dim that does not divide raises ``ValueError`` naming the leaf's path.
    Copies are fresh tensors: the placed tree never shares storage with
    ``tree``.  A leaf already placed by an equal sharding is kept as is."""
    if isinstance(shardings, NamedSharding):
        return _map_with_path(lambda path, x: place_leaf(x, shardings, path), tree)
    return _map_with_path(lambda path, x, s: place_leaf(x, s, path), tree, shardings)


def is_placed(tree: Any) -> bool:
    """Whether ``tree``'s leaves are :class:`PlacedTensor`\\ s."""
    leaves = []
    _map_with_path(lambda path, x: leaves.append(x), tree)
    return bool(leaves) and isinstance(leaves[0], PlacedTensor)


def unplace(tree: Any, device=None) -> Any:
    """Each placed leaf of ``tree`` as its whole tensor on ``device``
    (:meth:`PlacedTensor.full`); other leaves as they are."""
    return _map_with_path(
        lambda path, x: x.full(device) if isinstance(x, PlacedTensor) else x, tree)


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
    "NamedSharding",
    "PlacedTensor",
    "all_gather",
    "all_to_all",
    "batch_spec",
    "devices",
    "dp_axes",
    "gather",
    "is_placed",
    "make_mesh",
    "param_shardings",
    "param_specs",
    "place",
    "place_leaf",
    "pmax",
    "pmin",
    "psum",
    "reset_virtual_devices",
    "shard",
    "spec_for_path",
    "unplace",
    "virtual_devices",
]
