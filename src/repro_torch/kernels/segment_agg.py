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

:func:`segment_agg` is the wrapper: CUDA tensors launch the hand-written
Hopper kernel ``csrc/segment_agg.cu`` (built at first use) and raise if
they cannot; CPU tensors run :func:`segment_agg_plain`.  The kernel's
atomics add in another order than the plain version, so SUM agrees to
float tolerance and COUNT/MIN/MAX exactly.
"""
from __future__ import annotations

import ctypes

import torch

_NEUTRAL = {"sum": 0.0, "count": 0.0, "min": float("inf"), "max": float("-inf")}
_KIND_CODE = {"sum": 0, "count": 1, "min": 2, "max": 3}
_STRATEGY_CODE = {"scatter": 0, "onehot": 1}

# One CTA's private accumulator lives in dynamic shared memory: 224 KiB of
# the 227 KiB a Hopper block may hold (csrc kMaxOnehotGroups).
MAX_ONEHOT_GROUPS = 56 * 1024
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


def segment_agg(tickets: torch.Tensor, values: torch.Tensor, *, num_groups: int,
                kind: str = "sum", strategy: str = "scatter",
                morsel_size: int = 1024) -> torch.Tensor:
    """Fold ``(tickets, values)`` rows into a fresh ``(num_groups,)``
    float32 accumulator (see the module docstring).  CUDA tensors launch
    the Hopper kernel (counted in ``segment_agg.launches``); CPU tensors
    run :func:`segment_agg_plain`; any other device raises."""
    tickets, values = _prepare(tickets, values, num_groups, kind, strategy, morsel_size)
    dev = tickets.device
    if dev.type == "cpu":
        return segment_agg_plain(tickets, values, num_groups=num_groups, kind=kind,
                                 strategy=strategy, morsel_size=morsel_size)
    if dev.type != "cuda":
        raise ValueError(f"segment_agg runs on cuda or cpu tensors, not {dev}")
    acc = torch.full((num_groups,), _NEUTRAL[kind], dtype=torch.float32, device=dev)
    if tickets.shape[0] == 0 or num_groups == 0:  # nothing to launch
        return acc
    lib = _kernel_library()
    err = lib.segment_agg_launch(
        tickets.data_ptr(), values.data_ptr(), acc.data_ptr(), tickets.shape[0],
        num_groups, _KIND_CODE[kind], _STRATEGY_CODE[strategy],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "segment_agg kernel launch failed: " + lib.segment_agg_error_string(err).decode()
        )
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
                      morsel_size: int = 1024) -> torch.Tensor:
    """The plain PyTorch version of the segment kernel, on any device: one
    ``index_add_`` / ``scatter_reduce_`` into a neutral-filled accumulator
    with one parking slot past the end for rows whose ticket is < 0 or
    >= ``num_groups``.  Both strategies compute the same function, so both
    run this."""
    tickets, values = _prepare(tickets, values, num_groups, kind, strategy, morsel_size)
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
    return acc[:num_groups]
