"""Row segment sum: kernel B5, step 2 of the ticketed embedding's backward.

Replaces ``jax.ops.segment_sum`` in ``repro.models.layers._ticketed_embed_bwd``
(``src/repro/models/layers.py:150-154``; no Pallas kernel there).  One call
sums float32 rows into a fresh ``(num_groups, d)`` output at their
tickets: ``out[t]`` is the sum of ``rows[r]`` over ``tickets[r] == t`` for
``t`` in ``[0, num_groups)``, 0 where no row names ``t``; rows whose
ticket is -1 or ``>= num_groups`` are dropped, as the reference sends them
to a segment it drops.

:func:`segment_rows` is the wrapper: CUDA tensors launch the hand-written
Hopper kernel ``csrc/segment_rows.cu`` (built at first use; counted in
``segment_rows.launches``) and raise if they cannot; CPU tensors run
:func:`segment_rows_plain`.  The kernel adds a ticket's rows in no fixed
order, so it agrees with the plain version to float32 rounding (a sum
within a small multiple of Σ|row| of its ticket), not bit for bit.

Bound on the card: bytes, the rows and tickets read once and the sums
written once (8 MiB at qwen3-0.6b's 1024 rows of 1024 columns into 1024
tickets, ≈ 0.0025 ms at 3.35 TB/s).  A call is one launch and nothing
else: the kernel writes every element of the output, so the output is
allocated empty and not zeroed.  Each CTA sums a slice of columns for a
range of tickets: it sorts each round's rows by ticket in shared memory,
and each sum is added in the registers of the thread that stores it, with
no float atomic (see the source).  The wrapper's host work is kept lean:
the ctypes function is bound once, the stream is passed as its raw
handle, and the launcher makes no runtime query.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.launch.roofline import counted

_INT32_MAX = 0x7FFFFFFF


def _check(rows: torch.Tensor, tickets: torch.Tensor, num_groups: int):
    rs, ts = rows.shape, tickets.shape
    if len(rs) != 2 or len(ts) != 1 or rs[0] != ts[0]:
        raise ValueError(
            f"segment_rows takes rows (R, d) and tickets (R,); got {tuple(rs)} and {tuple(ts)}"
        )
    if rows.dtype is not torch.float32 or tickets.dtype is not torch.int32:
        raise ValueError(f"rows must be float32 and tickets int32, got {rows.dtype} and "
                         f"{tickets.dtype}")
    if rows.device != tickets.device:
        raise ValueError(f"rows lie on {rows.device}, tickets on {tickets.device}")
    if not 0 <= num_groups <= _INT32_MAX or rs[1] > _INT32_MAX:
        raise ValueError(f"num_groups={num_groups} / d={rs[1]} do not fit int32")
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not tickets.is_contiguous():
        tickets = tickets.contiguous()
    return rows, tickets


def _b5_work(rows, tickets, num_groups: int):
    """B5's bound (PERF.md §6): one add a row element; rows and tickets
    read once, the G × d sums written once."""
    r, d = rows.shape
    return r * d, 4 * (r * d + r + num_groups * d)


@counted(_b5_work)
def segment_rows(rows: torch.Tensor, tickets: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``(num_groups, d)`` float32 sums of ``rows`` by ticket (see the
    module docstring).  CUDA tensors launch the Hopper kernel; CPU tensors
    run :func:`segment_rows_plain`; ``meta`` tensors (a dry run) give the
    output's shape; any other device raises."""
    rows, tickets = _check(rows, tickets, num_groups)
    dev = rows.device
    if dev.type == "meta":
        return rows.new_empty((num_groups, rows.shape[1]))
    if dev.type == "cpu":
        return segment_rows_plain(rows, tickets, num_groups)
    if dev.type != "cuda":
        raise ValueError(f"segment_rows runs on cuda or cpu tensors, not {dev}")
    out = rows.new_empty((num_groups, rows.shape[1]))
    if out.numel() == 0:  # d == 0 or num_groups == 0: no element to write
        return out
    _launch(rows, tickets, out, num_groups)
    return out


segment_rows.launches = 0  # kernel launches (CUDA tensors only)


def _launch(rows: torch.Tensor, tickets: torch.Tensor, out: torch.Tensor,
            num_groups: int) -> None:
    """One launch (counted) into ``out``, a contiguous ``(num_groups, d)``
    float32 CUDA tensor on the rows' device with ``num_groups`` and ``d``
    > 0, which the kernel overwrites whole; ``rows`` and ``tickets`` as
    :func:`_check` returns them."""
    fn = _LAUNCHER or _bind()
    r, d = rows.shape
    p_rows, p_out = rows.data_ptr(), out.data_ptr()
    vec = d % 4 == 0 and (p_rows | p_out) % 16 == 0
    err = fn(p_rows, tickets.data_ptr(), p_out, r, d, num_groups, vec,
             torch._C._cuda_getCurrentRawStream(rows.get_device()))
    if err != 0:
        raise RuntimeError("segment_rows kernel launch failed: "
                           + _LIB.segment_rows_error_string(err).decode())
    segment_rows.launches += 1


_LIB = None       # the loaded library, bound once by _bind
_LAUNCHER = None  # its segment_rows_launch, argtypes set


def _bind():
    global _LIB, _LAUNCHER
    from repro_torch.kernels import build

    lib = build.load_library("segment_rows")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.segment_rows_launch
    fn.argtypes = [ptr] * 3 + [ctypes.c_longlong, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    lib.segment_rows_error_string.argtypes = [ctypes.c_int]
    lib.segment_rows_error_string.restype = ctypes.c_char_p
    _LIB, _LAUNCHER = lib, fn
    return fn


def segment_rows_plain(rows: torch.Tensor, tickets: torch.Tensor,
                       num_groups: int) -> torch.Tensor:
    """The plain PyTorch version, on any device: one ``index_add_`` into
    ``num_groups + 1`` rows, tickets outside ``[0, num_groups)`` sent to the
    last, which is dropped."""
    rows, tickets = _check(rows, tickets, num_groups)
    ok = (tickets >= 0) & (tickets < num_groups)
    idx = torch.where(ok, tickets, num_groups).long()
    out = torch.zeros((num_groups + 1, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, idx, rows)[:num_groups]
