"""Fold ticketed rows into a dense accumulator: the split route's second
kernel.

Port of ``repro.kernels.segment_agg``.  One call folds (ticket, value)
rows into a fresh ``(num_groups,)`` float32 accumulator that starts at the
kind's neutral (0 for sum/count, +inf for min, -inf for max).  ``count``
reads ones.  Rows whose ticket is < 0 are parked; rows whose ticket is
>= ``num_groups`` are dropped, as the reference's scatter drops an
out-of-range index.  Two strategies, as in the reference:

  * ``scatter``: every row updates the accumulator in device memory with
    an atomic;
  * ``onehot``: each CTA folds its rows into a private copy of the
    accumulator in shared memory, then flushes it once.  The TPU puts this
    contended small-G fold on the MXU; on Hopper shared-memory atomics do
    the same job.  It takes at most :data:`MAX_ONEHOT_GROUPS` groups (what
    one CTA's shared memory holds); above that the wrapper raises
    ``ValueError`` on every device rather than switch strategy.

``out=`` folds into a caller's accumulator in place instead of a fresh
one (the scan route's carried accumulators).  :func:`serialized_agg` folds
rows one at a time in row order (the reference's ``serialized_update``, a
measurement of full serialization): on CUDA tensors a kernel of the same
source in which one thread does every fold, from tiles of rows that the
CTA's other warps stage in shared memory, into an accumulator plane held
in shared memory up to :data:`MAX_SERIALIZED_SHARED_GROUPS` groups (in
device memory past it); :func:`serialized_agg_plain`'s row loop on CPU
tensors.

:func:`segment_agg` is the wrapper: CUDA tensors launch the hand-written
Hopper kernel ``csrc/segment_agg.cu`` (built at first use) and raise if
they cannot; CPU tensors run :func:`segment_agg_plain`.  The kernel's
atomics add in another order than the plain version, so SUM agrees to
float tolerance and COUNT/MIN/MAX exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import updates as up
from repro_torch.launch.roofline import counted

_NEUTRAL = {"sum": 0.0, "count": 0.0, "min": float("inf"), "max": float("-inf")}
_KIND_CODE = {"sum": 0, "count": 1, "min": 2, "max": 3}
_STRATEGY_CODE = {"scatter": 0, "onehot": 1}
_SERIALIZED_CODE = 2  # csrc kSerialized: one thread, rows in order

# One CTA's private accumulator lives in dynamic shared memory: 224 KiB of
# the 227 KiB a Hopper block may hold (csrc kMaxOnehotGroups).
MAX_ONEHOT_GROUPS = 56 * 1024
# The serialized kernel keeps the plane in shared memory beside its two
# staged tiles up to this many groups (csrc kMaxSerialSharedGroups).
MAX_SERIALIZED_SHARED_GROUPS = 52 * 1024
_INT32_MAX = 0x7FFFFFFF


def _prepare(tickets, values, num_groups, kind, strategy, morsel_size):
    """Checks shared by both paths; tickets → int32 and values → float32,
    contiguous, as ``segment_agg_pallas`` casts them."""
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown kind {kind!r}; available: {tuple(_KIND_CODE)}")
    if strategy not in _STRATEGY_CODE:
        raise ValueError(
            f"unknown strategy {strategy!r}; available: {tuple(_STRATEGY_CODE)}"
        )
    if not 0 <= num_groups <= _INT32_MAX:
        raise ValueError(f"num_groups={num_groups} does not fit int32")
    if strategy == "onehot" and num_groups > MAX_ONEHOT_GROUPS:
        raise ValueError(
            f"strategy='onehot' folds into one CTA's shared memory and takes at "
            f"most MAX_ONEHOT_GROUPS={MAX_ONEHOT_GROUPS} groups, not {num_groups}; "
            "use strategy='scatter'"
        )
    tickets = torch.as_tensor(tickets).to(torch.int32).contiguous()
    values = torch.as_tensor(values).to(torch.float32).contiguous()
    if tickets.dim() != 1 or values.shape != tickets.shape:
        raise ValueError(
            f"tickets {tuple(tickets.shape)} and values {tuple(values.shape)} must "
            "be the same 1-D shape"
        )
    if values.device != tickets.device:
        raise ValueError(f"values are on {values.device}, tickets on {tickets.device}")
    if morsel_size < 1 or tickets.shape[0] % morsel_size:
        raise ValueError(
            f"{tickets.shape[0]} rows are not a multiple of morsel_size={morsel_size}"
        )
    return tickets, values


def _check_out(out, num_groups, device):
    if out is None:
        return
    if (out.dtype != torch.float32 or tuple(out.shape) != (num_groups,)
            or not out.is_contiguous() or out.device != device):
        raise ValueError(
            f"out must be a contiguous ({num_groups},) float32 tensor on {device}, "
            f"got {tuple(out.shape)} {out.dtype} on {out.device}"
        )


def _launch(tickets, values, acc, num_groups, kind, strategy_code) -> None:
    lib = _kernel_library()
    err = lib.segment_agg_launch(
        tickets.data_ptr(), values.data_ptr(), acc.data_ptr(), tickets.shape[0],
        num_groups, _KIND_CODE[kind], strategy_code,
        torch._C._cuda_getCurrentRawStream(tickets.get_device()),
    )
    if err != 0:
        raise RuntimeError(
            "segment_agg kernel launch failed: " + lib.segment_agg_error_string(err).decode()
        )


def _segment_work(tickets, values, *, num_groups: int, **_):
    """The segment kernel's bound (PERF.md §6): one operation a row;
    tickets and values read once, the accumulator written once."""
    n = tickets.shape[0]
    return n, 8 * n + 4 * num_groups


@counted(_segment_work)
def segment_agg(tickets: torch.Tensor, values: torch.Tensor, *, num_groups: int,
                kind: str = "sum", strategy: str = "scatter",
                morsel_size: int = 1024, out: torch.Tensor | None = None) -> torch.Tensor:
    """Fold ``(tickets, values)`` rows into a fresh ``(num_groups,)``
    float32 accumulator, or into ``out`` in place (see the module
    docstring).  CUDA tensors launch the Hopper kernel (counted in
    ``segment_agg.launches``); CPU tensors run :func:`segment_agg_plain`;
    ``meta`` tensors (a dry run) give the accumulator's shape; any other
    device raises."""
    tickets, values = _prepare(tickets, values, num_groups, kind, strategy, morsel_size)
    dev = tickets.device
    _check_out(out, num_groups, dev)
    if dev.type == "meta":
        return out if out is not None else values.new_empty((num_groups,))
    if dev.type == "cpu":
        return segment_agg_plain(tickets, values, num_groups=num_groups, kind=kind,
                                 strategy=strategy, morsel_size=morsel_size, out=out)
    if dev.type != "cuda":
        raise ValueError(f"segment_agg runs on cuda or cpu tensors, not {dev}")
    acc = out
    if acc is None:
        acc = torch.full((num_groups,), _NEUTRAL[kind], dtype=torch.float32, device=dev)
    if tickets.shape[0] == 0 or num_groups == 0:  # nothing to launch
        return acc
    _launch(tickets, values, acc, num_groups, kind, _STRATEGY_CODE[strategy])
    segment_agg.launches += 1
    return acc


segment_agg.launches = 0  # kernel launches (CUDA tensors only)


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("segment_agg")
    fn = lib.segment_agg_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 3 + [ctypes.c_longlong, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        lib.segment_agg_error_string.argtypes = [ctypes.c_int]
        lib.segment_agg_error_string.restype = ctypes.c_char_p
    return lib


def segment_agg_plain(tickets: torch.Tensor, values: torch.Tensor, *,
                      num_groups: int, kind: str = "sum",
                      strategy: str = "scatter",
                      morsel_size: int = 1024,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the segment kernel, on any device: one
    ``index_add_`` / ``scatter_reduce_`` into a neutral-filled accumulator
    with one parking slot past the end for rows whose ticket is < 0 or
    >= ``num_groups``, then combined into ``out`` when one is given.  Both
    strategies compute the same function, so both run this."""
    tickets, values = _prepare(tickets, values, num_groups, kind, strategy, morsel_size)
    _check_out(out, num_groups, tickets.device)
    t = tickets.to(torch.int64)
    ok = (t >= 0) & (t < num_groups)
    t = torch.where(ok, t, torch.full_like(t, num_groups))
    v = torch.ones_like(values) if kind == "count" else values
    acc = torch.full((num_groups + 1,), _NEUTRAL[kind], dtype=torch.float32,
                     device=tickets.device)
    if kind in ("sum", "count"):
        acc.index_add_(0, t, v)
    else:
        acc.scatter_reduce_(0, t, v, "amin" if kind == "min" else "amax")
    if out is None:
        return acc[:num_groups]
    return up._combine_(out, acc[:num_groups], kind)


def _column(x, dtype):
    """``x`` as a contiguous 1-D ``dtype`` tensor; ``x`` itself when it is one."""
    if isinstance(x, torch.Tensor) and x.dtype == dtype and x.dim() == 1 and x.is_contiguous():
        return x
    return torch.as_tensor(x).to(dtype).reshape(-1).contiguous()


def _check_serialized(acc, tickets, values):
    if acc.dim() != 1 or acc.dtype != torch.float32 or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous 1-D float32 tensor, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    tickets = _column(tickets, torch.int32)
    values = _column(values, torch.float32)
    if values.shape != tickets.shape:
        raise ValueError(f"tickets {tuple(tickets.shape)} and values "
                         f"{tuple(values.shape)} must be the same length")
    if not acc.device == tickets.device == values.device:
        raise ValueError("acc, tickets and values must be on one device")
    return tickets, values


def serialized_agg(acc: torch.Tensor, tickets: torch.Tensor, values: torch.Tensor, *,
                   kind: str = "sum") -> torch.Tensor:
    """Fold ``(tickets, values)`` rows into ``acc`` IN PLACE one row at a
    time, in row order; rows whose ticket is < 0 or >= ``len(acc)`` are
    skipped and ``count`` adds 1.0 a row.  CUDA tensors launch the
    serialized kernel of ``csrc/segment_agg.cu`` (strategy 2: one thread
    folds every row; counted in
    ``serialized_agg.launches``) and raise if they cannot; CPU tensors run
    :func:`serialized_agg_plain`; any other device raises."""
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown kind {kind!r}; available: {tuple(_KIND_CODE)}")
    tickets, values = _check_serialized(acc, tickets, values)
    dev = acc.device
    if dev.type == "cpu":
        return serialized_agg_plain(acc, tickets, values, kind=kind)
    if dev.type != "cuda":
        raise ValueError(f"serialized_agg runs on cuda or cpu tensors, not {dev}")
    if tickets.shape[0] == 0 or acc.shape[0] == 0:
        return acc
    _launch(tickets, values, acc, acc.shape[0], kind, _SERIALIZED_CODE)
    serialized_agg.launches += 1
    return acc


serialized_agg.launches = 0  # kernel launches (CUDA tensors only)


def serialized_agg_plain(acc: torch.Tensor, tickets: torch.Tensor, values: torch.Tensor,
                         *, kind: str = "sum") -> torch.Tensor:
    """The plain version of :func:`serialized_agg`: a row loop over host
    copies in float32 (each sum rounded as the kernel rounds it; min / max
    replace the accumulator only when the value is smaller / larger),
    copied back into ``acc`` in place."""
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown kind {kind!r}; available: {tuple(_KIND_CODE)}")
    tickets, values = _check_serialized(acc, tickets, values)
    w = acc.detach().cpu().numpy().copy()
    g = w.shape[0]
    one = np.float32(1.0)
    for t, v in zip(tickets.cpu().tolist(), values.cpu().numpy()):
        if t < 0 or t >= g:
            continue
        if kind in ("sum", "count"):
            w[t] = w[t] + (one if kind == "count" else v)
        elif kind == "min":
            if v < w[t]:
                w[t] = v
        elif v > w[t]:
            w[t] = v
    acc.copy_(torch.from_numpy(w))
    return acc
