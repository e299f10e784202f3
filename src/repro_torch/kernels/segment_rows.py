"""Row segment sum: kernel B5, step 2 of the ticketed embedding's backward.

Replaces ``jax.ops.segment_sum`` in ``repro.models.layers._ticketed_embed_bwd``
(``src/repro/models/layers.py:150-154``; no Pallas kernel there).  One call
adds float32 rows into a fresh ``(num_groups, d)`` accumulator at their
tickets: ``out[t] += rows[r]`` for ``t = tickets[r]`` in
``[0, num_groups)``; rows whose ticket is -1 or ``>= num_groups`` are
dropped, as the reference sends them to a segment it drops.

:func:`segment_rows` is the wrapper: CUDA tensors launch the hand-written
Hopper kernel ``csrc/segment_rows.cu`` (built at first use; counted in
``segment_rows.launches``) and raise if they cannot; CPU tensors run
:func:`segment_rows_plain`.  The kernel adds with device atomics in no
fixed order, so it agrees with the plain version to float32 rounding (a
sum within a small multiple of Σ|row| of its ticket), not bit for bit.

Bound on the card: bytes, the rows and tickets read once and the sums
written once (8 MiB at qwen3-0.6b's 1024 rows of 1024 columns into 1024
tickets, ≈ 0.0025 ms at 3.35 TB/s); a launch costs more than that, so the
launch rules.  The kernel gives each row a warp that adds 16 bytes a lane
with one float4 atomic (see the source).
"""
from __future__ import annotations

import ctypes

import torch

_INT32_MAX = 0x7FFFFFFF


def _check(rows: torch.Tensor, tickets: torch.Tensor, num_groups: int):
    if rows.dim() != 2 or tickets.dim() != 1 or rows.shape[0] != tickets.shape[0]:
        raise ValueError(
            f"segment_rows takes rows (R, d) and tickets (R,); got {tuple(rows.shape)} and "
            f"{tuple(tickets.shape)}"
        )
    if rows.dtype != torch.float32 or tickets.dtype != torch.int32:
        raise ValueError(f"rows must be float32 and tickets int32, got {rows.dtype} and "
                         f"{tickets.dtype}")
    if rows.device != tickets.device:
        raise ValueError(f"rows lie on {rows.device}, tickets on {tickets.device}")
    if not 0 <= num_groups <= _INT32_MAX or rows.shape[1] > _INT32_MAX:
        raise ValueError(f"num_groups={num_groups} / d={rows.shape[1]} do not fit int32")
    return rows.contiguous(), tickets.contiguous()


def segment_rows(rows: torch.Tensor, tickets: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``(num_groups, d)`` float32 sums of ``rows`` by ticket (see the
    module docstring).  CUDA tensors launch the Hopper kernel; CPU tensors
    run :func:`segment_rows_plain`; any other device raises."""
    rows, tickets = _check(rows, tickets, num_groups)
    dev = rows.device
    if dev.type == "cpu":
        return segment_rows_plain(rows, tickets, num_groups)
    if dev.type != "cuda":
        raise ValueError(f"segment_rows runs on cuda or cpu tensors, not {dev}")
    r, d = rows.shape
    out = torch.zeros((num_groups, d), dtype=torch.float32, device=dev)
    if r == 0 or d == 0 or num_groups == 0:
        return out
    vec = d % 4 == 0 and rows.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _kernel_library()
    err = lib.segment_rows_launch(
        rows.data_ptr(), tickets.data_ptr(), out.data_ptr(), r, d, num_groups, int(vec),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "segment_rows kernel launch failed: " + lib.segment_rows_error_string(err).decode()
        )
    segment_rows.launches += 1
    return out


segment_rows.launches = 0  # kernel launches (CUDA tensors only)


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("segment_rows")
    fn = lib.segment_rows_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 3 + [ctypes.c_longlong, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        lib.segment_rows_error_string.argtypes = [ctypes.c_int]
        lib.segment_rows_error_string.restype = ctypes.c_char_p
    return lib


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
