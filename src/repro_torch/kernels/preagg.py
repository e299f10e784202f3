"""Local pre-aggregation of the partitioned baseline: each worker folds its
rows into a small direct-mapped table and spills the rows that miss it.

Card counterpart of the reference's jnp loop ``preagg_morsel`` under
``_partitioned_impl`` (``repro.core.partitioned``: a ``vmap`` over workers
of a ``lax.scan`` over morsels; no Pallas kernel).  One call takes a
chunk's keys and values laid out as ``(W, R)`` (worker ``w`` owns row
``w``), a kind, the table size ``C`` (a power of two) and the morsel size
``msize`` (R a multiple of it; None: the whole row), and returns

  * ``keys`` ``(W, C)`` int32: each worker's table keys, ``EMPTY_I32`` in
    free slots;
  * ``vals`` ``(W, C)`` float32: the partial aggregate of each slot (the
    kind's neutral in free slots; count counts 1.0 a row);
  * ``cnts`` ``(W, C)`` float32: the rows folded into each slot;
  * ``spill`` ``(W, R)`` bool: the live rows that missed their worker's
    table (their slot held another key, or they lost the install vote to
    another key).

The result does not depend on the morsel size: the first-row rule.  The
reference takes a worker's rows morsel by morsel and, per morsel, lets
every live row whose slot is free vote with its lane; the lowest lane
installs its key, and every live row whose slot then holds its own key
folds.  A key never leaves its slot, and (morsel, lane) order is the
worker's row order, so slot ``s`` ends up holding the key of the worker's
first live row whose ``slot_hash`` is ``s``, and a live row folds iff its
slot holds its key; the rest spill.  So ``keys``, ``spill`` and ``cnts``
equal the reference's bit for bit at every morsel size, and ``vals`` up
to the order of float sums.  ``morsel`` is still checked (R a multiple of
it) and drives the plain version's steps, but the kernel never reads it.

:func:`preagg` is the wrapper: CUDA tensors launch the hand-written Hopper
kernels of ``csrc/preagg.cu`` (:func:`launch`: a vote pass and a fold pass,
each over many CTAs per worker; built at first use; counted in
``preagg.launches``) and raise if they cannot; CPU tensors run
:func:`preagg_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32, slot_hash

KINDS = ("sum", "count", "min", "max")
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}


def _prepare(keys, values, kind, capacity, msize):
    """Checks shared by both paths; returns (keys int32, values float32 or
    None for count, msize), contiguous, on the keys' device."""
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown kind {kind!r}; available: {KINDS}")
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of 2, got {capacity}")
    # (each call below is skipped where it would be a no-op: the card path
    # runs this on every chunk, with the device idle until the launch)
    if not isinstance(keys, torch.Tensor):
        keys = torch.as_tensor(keys)
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"keys must be a (W, R) int32 tensor, got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    w, r = keys.shape
    msize = (r or 1) if msize is None else int(msize)
    if msize < 1 or r % msize:
        raise ValueError(f"{r} rows per worker are not a multiple of morsel {msize}")
    if kind == "count":
        values = None
    else:
        if not isinstance(values, torch.Tensor):
            values = torch.as_tensor(values)
        if values.shape != keys.shape or values.device != keys.device:
            raise ValueError(f"values {tuple(values.shape)} on {values.device} do not match "
                             f"keys {tuple(keys.shape)} on {keys.device}")
        if values.dtype != torch.float32:
            values = values.to(torch.float32)
        if not values.is_contiguous():
            values = values.contiguous()
    if not keys.is_contiguous():
        keys = keys.contiguous()
    return keys, values, msize


def preagg(keys: torch.Tensor, values: torch.Tensor | None, *, kind: str, capacity: int,
           morsel: int | None = None):
    """Pre-aggregate each worker's rows (see the module docstring).  CUDA
    tensors launch the Hopper kernels; CPU tensors run
    :func:`preagg_plain`; any other device raises.  Returns ``(keys, vals,
    cnts, spill)``."""
    keys, values, msize = _prepare(keys, values, kind, capacity, morsel)
    dev = keys.device
    if dev.type == "cpu":
        return _plain(keys, values, kind, capacity, msize)
    if dev.type != "cuda":
        raise ValueError(f"preagg runs on cuda or cpu tensors, not {dev}")
    return launch(keys, values, kind, capacity)


preagg.launches = 0  # launches of the kernel pair (CUDA tensors only)

# rows of a CTA's tile (None: about two CTAs an SM, chosen by the launcher)
TILE_ROWS: int | None = None
_SKIP_FLUSH = {None: 0, "first": 1, "fold": 2}


def launch(keys: torch.Tensor, values: torch.Tensor | None, kind: str, capacity: int, *,
           skip_flush: str | None = None):
    """The kernel pair on checked ``(W, R)`` CUDA tensors (int32 keys,
    float32 values or None for count, both contiguous): the scratch fill
    and the two passes on the current stream.  The key table is also the
    passes' scratch (each slot's first row, then its key), with W done
    counters in the rows after it; vals and cnts share one allocation.  The
    device waits on this host work, so it is three allocations and two
    views.  ``skip_flush`` ("first" or "fold") names a pass whose flush is
    left out, for timing only (the result is then wrong).  Records ``(CTAs per pass, tile
    rows)`` in ``launch.grid``."""
    w, r = keys.shape
    dev = keys.device
    lib = _kernel_library()
    tkeys = torch.empty((w + -(-w // capacity), capacity), dtype=torch.int32, device=dev)
    tables = torch.empty((2, w, capacity), dtype=torch.float32, device=dev)
    spill = torch.empty((w, r), dtype=torch.bool, device=dev)
    grid = (ctypes.c_int * 2)()
    at = tables.data_ptr()
    err = lib.preagg_launch(
        keys.data_ptr(), None if values is None else values.data_ptr(), w, r, capacity,
        _KIND_CODE[kind], TILE_ROWS or 0, _SKIP_FLUSH[skip_flush], tkeys.data_ptr(),
        at, at + 4 * w * capacity, spill.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(), grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("preagg kernel launch failed: "
                           + lib.preagg_error_string(err).decode())
    preagg.launches += 1
    launch.grid = (grid[0], grid[1])
    tvals, tcnts = tables.unbind()
    return tkeys[:w], tvals, tcnts, spill


launch.grid = (0, 0)


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("preagg")
    fn = lib.preagg_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, i32, ptr, ptr, ptr, ptr, i32,
                       ctypes.POINTER(ctypes.c_int), ptr]
        fn.restype = ctypes.c_int
        lib.preagg_error_string.argtypes = [i32]
        lib.preagg_error_string.restype = ctypes.c_char_p
    return lib


def preagg_plain(keys: torch.Tensor, values: torch.Tensor | None, *, kind: str,
                 capacity: int, morsel: int | None = None):
    """The plain PyTorch version, on any device, vectorised over workers:
    one step per morsel index on ``(W, msize)`` tensors, the install vote a
    ``scatter_reduce_(..., "amin")`` of lanes over the W·C slots (one
    parking slot past the end for rows that do not vote)."""
    keys, values, msize = _prepare(keys, values, kind, capacity, morsel)
    return _plain(keys, values, kind, capacity, msize)


def _plain(keys, values, kind, capacity, msize):
    w, r = keys.shape
    dev = keys.device
    park = w * capacity
    tkeys = torch.full((park + 1,), EMPTY_I32, dtype=torch.int32, device=dev)
    tvals = up.init_acc(park + 1, kind, device=dev)
    tcnts = torch.zeros((park + 1,), dtype=torch.float32, device=dev)
    spill = torch.zeros((w, r), dtype=torch.bool, device=dev)
    for m0 in range(0, r, msize):
        v = None if values is None else values[:, m0:m0 + msize]
        spill[:, m0:m0 + msize] = preagg_step(tkeys, tvals, tcnts, keys[:, m0:m0 + msize], v,
                                              kind=kind, capacity=capacity)
    return (tkeys[:park].reshape(w, capacity), tvals[:park].reshape(w, capacity),
            tcnts[:park].reshape(w, capacity), spill)


def preagg_step(tkeys, tvals, tcnts, keys, values, *, kind: str, capacity: int):
    """One morsel of every worker (``keys`` ``(W, m)`` int32, ``values``
    ``(W, m)`` float32 or None for count) into the flat tables ``tkeys``,
    ``tvals``, ``tcnts`` of ``W·capacity + 1`` slots (worker ``w`` owns
    slots ``[w·capacity, (w+1)·capacity)``; the last slot parks the rows
    that do not fold), IN PLACE.  Returns the ``(W, m)`` spill mask."""
    w, m = keys.shape
    dev = keys.device
    park = w * capacity
    lane = torch.arange(m, dtype=torch.int64, device=dev).expand(w, m)
    valid = keys != EMPTY_I32
    slot = (torch.arange(w, dtype=torch.int64, device=dev) * capacity)[:, None] + slot_hash(
        keys, capacity)
    empty = valid & (tkeys[slot] == EMPTY_I32)
    claims = torch.full((park + 1,), m, dtype=torch.int64, device=dev)
    claims.scatter_reduce_(0, torch.where(empty, slot, park).reshape(-1), lane.reshape(-1),
                           "amin")
    won = empty & (claims[slot] == lane)
    tkeys[slot[won]] = keys[won]
    fold = valid & (tkeys[slot] == keys)
    at = torch.where(fold, slot, park).reshape(-1)
    if kind in ("sum", "count"):
        v = torch.ones_like(keys, dtype=torch.float32) if kind == "count" else values
        tvals.index_add_(0, at, torch.where(fold, v, 0.0).reshape(-1))
    else:
        v = torch.where(fold, values, up.neutral(kind).item())
        tvals.scatter_reduce_(0, at, v.reshape(-1), "amin" if kind == "min" else "amax")
    tcnts.index_add_(0, at, fold.to(torch.float32).reshape(-1))
    return valid & ~fold
