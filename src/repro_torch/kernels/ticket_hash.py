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
rows get -1 whenever the table has room for every key:
:func:`ticket_map_discrepancies` counts the ways an output breaks that.
The kernel keeps a slot's key and ticket in one 64-bit word, so on a CUDA
device ``table_keys`` and ``table_tickets`` are strided views of it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import EMPTY_I32, to_i32_bits
from repro_torch.launch.roofline import counted

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


def _ticket_work(keys, *, capacity: int, max_groups: int, **_):
    """The ticket kernel's bound (PERF.md §6), in bytes (no FLOP): keys
    read and tickets written once, the table's 8-byte slots, ``key_by_ticket``
    and the count written once."""
    n = keys.shape[0]
    return 0, 8 * n + 8 * capacity + 4 * max_groups + 4


@counted(_ticket_work)
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
    :func:`ticket_hash_plain`; ``meta`` tensors (a dry run) give the
    outputs' shapes; any other device raises."""
    keys = _as_keys(keys)
    _check(keys, capacity, max_groups, morsel_size)
    dev = keys.device
    if dev.type == "meta":
        return (torch.empty_like(keys), keys.new_empty((capacity,)), keys.new_empty((capacity,)),
                keys.new_empty((max_groups,)), keys.new_empty(()))
    if dev.type == "cpu":
        return ticket_hash_plain(keys, capacity=capacity, max_groups=max_groups,
                                 morsel_size=morsel_size)
    if dev.type != "cuda":
        raise ValueError(f"ticket_hash runs on cuda or cpu tensors, not {dev}")
    bufs = _buffers(keys.shape[0], capacity, max_groups, dev)
    _launch(keys, bufs, _FILL | _TICKET)  # one launcher call, nothing between
    return _outputs(bufs)


ticket_hash.launches = 0  # kernel launches (CUDA tensors only)


def _buffers(n: int, capacity: int, max_groups: int, device):
    """The memory of one kernel call on ``n`` rows, unfilled, in two
    allocations: the table as (C,) 64-bit slot words (key in the low half,
    ticket in the high half) held as 2C int32; and one int32 buffer of
    ``key_by_ticket`` (G), the count, the tickets (n) and, where the shapes
    allow the kernel's region mode, its scratch (from a multiple of 4
    words, for its 8-byte entries).  Returns ``(slots, aux, g, n, scratch
    offset or None)``."""
    slots = torch.empty((2 * capacity,), dtype=torch.int32, device=device)
    words = _kernel_library().ticket_hash_scratch_ints(n, capacity)
    head = max_groups + 1 + n
    off = -(-head // 4) * 4 if words else None
    aux = torch.empty((off + words if words else head,), dtype=torch.int32, device=device)
    return slots, aux, max_groups, n, off


def _outputs(bufs):
    """``(tickets (n,), table_keys (C,), table_tickets (C,), key_by_ticket
    (G,), count ())`` as views of :func:`_buffers` (the table's two as
    strided views of the slot words)."""
    slots, aux, g, n, _ = bufs
    return aux[g + 1:g + 1 + n], slots[0::2], slots[1::2], aux[:g], aux[g]


_FILL, _TICKET = 1, 2  # the launcher's phases


def _launch(keys, bufs, phases: int) -> None:
    """One launcher call on :func:`_buffers`: the fill of the fresh state
    (``_FILL``) and/or the ticket kernels on ``keys`` (``_TICKET``;
    counted when there are rows)."""
    slots, aux, g, n, off = bufs
    lib = _kernel_library()
    base = aux.data_ptr()
    err = lib.ticket_hash_launch(
        keys.data_ptr() if keys is not None else None, base + 4 * (g + 1), slots.data_ptr(),
        base, base + 4 * g, base + 4 * off if off is not None else None, n,
        slots.shape[0] // 2, g, phases, torch.cuda.current_stream(slots.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "ticket_hash kernel launch failed: " + lib.ticket_hash_error_string(err).decode()
        )
    if phases & _TICKET and n > 0:
        ticket_hash.launches += 1


def fresh_outputs(n: int, *, capacity: int, max_groups: int, device):
    """The state of one call on ``n`` rows before its ticket kernels run,
    on a CUDA ``device`` (:func:`ticket_hash` makes it and runs them in one
    launcher call; this and :func:`launch` split the two to time them
    apart): the buffers, with ``key_by_ticket`` all ``EMPTY_I32``, the
    count 0 and the table empty (``EMPTY_I32`` keys, ticket 0) — except
    where the shapes allow the kernel's region mode (a table past the L2
    with at most one row per 16 slots): there the ticket kernels make the
    state themselves, after a sample of the keys has chosen the mode, and
    this only allocates."""
    bufs = _buffers(n, capacity, max_groups, device)
    _launch(None, bufs, _FILL)
    return bufs


def launch(keys: torch.Tensor, bufs) -> tuple:
    """Ticket ``keys`` (contiguous int32 on a CUDA device) with the
    buffers from :func:`fresh_outputs`, on the current stream; counts the
    launch (none for no rows) and returns :func:`ticket_hash`'s outputs.
    Raises if the kernel cannot be built or launched."""
    _launch(keys, bufs, _TICKET)
    return _outputs(bufs)


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("ticket_hash")
    fn = lib.ticket_hash_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [ctypes.c_longlong, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        lib.ticket_hash_scratch_ints.argtypes = [ctypes.c_longlong, i32]
        lib.ticket_hash_scratch_ints.restype = ctypes.c_longlong
        lib.ticket_hash_error_string.argtypes = [ctypes.c_int]
        lib.ticket_hash_error_string.restype = ctypes.c_char_p
    return lib


def ticket_map_discrepancies(keys: torch.Tensor, out, ref, *, full: bool = False) -> int:
    """How far ``out`` (the outputs of :func:`ticket_hash`) breaks the
    contract the kernel keeps with ``ref`` (:func:`ticket_hash_plain`'s
    outputs for the same keys, capacity and bound); 0 when it keeps it.

    Tickets may be numbered differently, so the map is compared, not the
    numbers.  Counted: |Δcount|; table tickets that are not exactly
    1..count (each missing, duplicated or out-of-range ticket); slots whose
    ticket t <= G does not name their key in ``key_by_ticket``, and entries
    of ``key_by_ticket`` past min(count, G) that are not EMPTY; resolved
    rows whose ticket is past the count or names another key; rows resolved
    differently from ``ref`` (or, when the table is ``full``, rows left -1
    whose key is in the table and resolved rows whose key is not); keys in
    one table only (not counted when ``full``: which keys fill a full table
    depends on the order of the claims)."""
    keys = _as_keys(keys)
    kt, ktk, ktt, kkbt, kc = out
    pt, ptk, ptt, _, pc = ref
    n = int(kc)
    bad = abs(n - int(pc))
    occ = ktt > 0
    tick, tkey = ktt[occ].long(), ktk[occ]
    hist = torch.bincount(tick.clamp(max=n + 1), minlength=n + 2)
    bad += int((hist[1:n + 1] - 1).abs().sum()) + int(hist[n + 1:].sum())
    g = kkbt.shape[0]
    inb = tick <= g
    bad += int((kkbt[tick[inb] - 1] != tkey[inb]).sum())
    bad += int((kkbt[min(n, g):] != EMPTY_I32).sum())
    valid = keys != EMPTY_I32
    ok = kt >= 0
    rows = kt[ok].long()
    inr = rows < n
    bad += int((~inr).sum())
    key_of = torch.full((n,), EMPTY_I32, dtype=torch.int32, device=keys.device)
    named = tick <= n
    key_of[tick[named] - 1] = tkey[named]
    bad += int((key_of[rows[inr]] != keys[ok][inr]).sum())
    if full:
        bad += int((torch.isin(keys[valid], tkey) != ok[valid]).sum())
    else:
        bad += int(((ok != (pt >= 0)) | (ok != valid)).sum())
        pkey = ptk[ptt > 0]
        bad += int((~torch.isin(tkey, pkey)).sum()) + int((~torch.isin(pkey, tkey)).sum())
    return bad


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
