"""GET_OR_INSERT ticketing of a key column: the split route's first kernel.

Port of ``repro.kernels.ticket_hash``.  One call tickets a whole key column
against ONE table made fresh for the call: every row gets the 0-based
ticket of its key (-1 for ``EMPTY_I32`` padding and for rows a saturated
table could not place), and the call returns the table, ``key_by_ticket``
and the count of tickets issued.  Tickets are gap-free (1..count inside the
table); ``count`` may exceed ``max_groups``, and then ``key_by_ticket``
holds only the first ``max_groups`` keys — the caller checks ``count``.

:func:`ticket_hash` is the wrapper.  For CUDA tensors it launches the
hand-written Hopper kernel ``csrc/ticket_hash.cu`` (built at first use,
``kernels/build.py``) and raises if it cannot; for CPU tensors it runs
:func:`ticket_hash_plain`, the Pallas kernel's claim-round protocol morsel
by morsel (``core.ticketing.get_or_insert``), which matches
``ticket_hash_pallas(..., interpret=True)`` ticket for ticket.

The kernel races rows of all morsels at once with device-scope atomics, so
its ticket numbering differs from run to run.  It agrees with the plain
version on the key → ticket map up to that numbering (one ticket per key,
gap-free, consistent with ``key_by_ticket``), on ``count``, and on which
rows get -1 whenever the table has room for every key.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import EMPTY_I32, to_i32_bits

_INT32_MAX = 0x7FFFFFFF


def _check(keys: torch.Tensor, capacity: int, max_groups: int, morsel_size: int):
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of 2, got {capacity}")
    if not 0 <= max_groups <= _INT32_MAX or capacity > _INT32_MAX:
        raise ValueError(f"capacity={capacity} / max_groups={max_groups} do not fit int32")
    if morsel_size < 1 or keys.shape[0] % morsel_size:
        raise ValueError(
            f"{keys.shape[0]} keys are not a multiple of morsel_size={morsel_size}: "
            "pad with EMPTY_I32"
        )


def _as_keys(keys: torch.Tensor) -> torch.Tensor:
    """Any integer key column → contiguous int32 bit patterns."""
    keys = torch.as_tensor(keys)
    if keys.dtype != torch.int32:
        keys = to_i32_bits(keys)
    return keys.contiguous()


def ticket_hash(keys: torch.Tensor, *, capacity: int, max_groups: int,
                morsel_size: int = 1024):
    """Ticket a key column against a fresh table of ``capacity`` slots.

    Args:
      keys: (N,) integer keys (int32 bit patterns, or any integer dtype
        holding the uint32 value); N a multiple of ``morsel_size`` (pad
        with ``EMPTY_I32``).
      capacity: table slots, a power of two.
      max_groups: length of ``key_by_ticket``.

    Returns ``(tickets (N,), table_keys (C,), table_tickets (C,),
    key_by_ticket (G,), count ())``, all int32.  CUDA tensors launch the
    Hopper kernel (counted in ``ticket_hash.launches``); CPU tensors run
    :func:`ticket_hash_plain`; any other device raises."""
    keys = _as_keys(keys)
    _check(keys, capacity, max_groups, morsel_size)
    dev = keys.device
    if dev.type == "cpu":
        return ticket_hash_plain(keys, capacity=capacity, max_groups=max_groups,
                                 morsel_size=morsel_size)
    if dev.type != "cuda":
        raise ValueError(f"ticket_hash runs on cuda or cpu tensors, not {dev}")
    n = keys.shape[0]
    tickets = torch.empty((n,), dtype=torch.int32, device=dev)
    tkeys = torch.full((capacity,), EMPTY_I32, dtype=torch.int32, device=dev)
    ttks = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    kbt = torch.full((max_groups,), EMPTY_I32, dtype=torch.int32, device=dev)
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    if n == 0:  # nothing to launch: the fresh table is the answer
        return tickets, tkeys, ttks, kbt, count[0]
    lib = _kernel_library()
    err = lib.ticket_hash_launch(
        keys.data_ptr(), tickets.data_ptr(), tkeys.data_ptr(), ttks.data_ptr(),
        kbt.data_ptr(), count.data_ptr(), n, capacity, max_groups,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "ticket_hash kernel launch failed: " + lib.ticket_hash_error_string(err).decode()
        )
    ticket_hash.launches += 1
    return tickets, tkeys, ttks, kbt, count[0]


ticket_hash.launches = 0  # kernel launches (CUDA tensors only)


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("ticket_hash")
    fn = lib.ticket_hash_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [ctypes.c_longlong, i32, i32, ptr]
        fn.restype = ctypes.c_int
        lib.ticket_hash_error_string.argtypes = [ctypes.c_int]
        lib.ticket_hash_error_string.restype = ctypes.c_char_p
    return lib


def ticket_hash_plain(keys: torch.Tensor, *, capacity: int, max_groups: int,
                      morsel_size: int = 1024):
    """The plain PyTorch version of the ticket kernel, on any device: a
    fresh table, then ``core.ticketing.get_or_insert`` (claim rounds, lowest
    lane wins, at most ``2C + 2`` rounds) over each morsel in order — the
    ``_ticket_kernel`` grid step for step.  Same outputs as
    :func:`ticket_hash`."""
    keys = _as_keys(keys)
    _check(keys, capacity, max_groups, morsel_size)
    table = tk.make_table(capacity, max_groups, device=keys.device)
    tickets = torch.empty_like(keys)
    for lo in range(0, keys.shape[0], morsel_size):
        tickets[lo:lo + morsel_size], table = tk.get_or_insert(
            table, keys[lo:lo + morsel_size])
    return tickets, table.keys, table.tickets, table.key_by_ticket, table.count
