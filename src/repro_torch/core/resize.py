"""Hash-table resizing (paper §4.4), bit for bit with ``repro.core.resize``.

Every stored key owns an immutable ticket, so migration into a bigger
table is a pure relocation: the same claim rounds as
:func:`~repro_torch.core.ticketing.get_or_insert` without ticket issuance.
The key→ticket map is preserved exactly.  :func:`migrate` is the plain
version of the card's migration kernel (``kernels.table_ops.migrate``);
the grows take the relocation as an argument, so this module imports no
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import EMPTY_I32, slot_hash, table_capacity


def migrate(table: tk.TicketTable, new_capacity: int) -> tk.TicketTable:
    """Relocate all (key, ticket) pairs into a new table of
    ``new_capacity`` slots.  ``key_by_ticket`` (the ``max_groups``
    contract) is kept as it is."""
    if new_capacity & (new_capacity - 1):
        raise ValueError(f"new_capacity must be a power of 2, got {new_capacity}")
    dev = table.keys.device
    live = table.tickets > 0
    keys = torch.where(live, table.keys, torch.full_like(table.keys, EMPTY_I32))
    n = keys.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    mask = new_capacity - 1
    slot = slot_hash(keys, new_capacity)
    nk = torch.full((new_capacity,), EMPTY_I32, dtype=torch.int32, device=dev)
    nt = torch.zeros((new_capacity,), dtype=torch.int32, device=dev)
    active = live.clone()
    while bool(active.any()):
        probed = nt[slot]
        empty = active & (probed == 0)
        taken = active & (probed != 0)
        slot2 = torch.where(taken, (slot + 1) & mask, slot)
        claims = torch.full((new_capacity + 1,), n, dtype=torch.int64, device=dev)
        claims.scatter_reduce_(
            0, torch.where(empty, slot, new_capacity), lane, "amin"
        )
        won = empty & (claims[slot] == lane)
        nk[slot[won]] = keys[won]
        nt[slot[won]] = table.tickets[won]
        slot = slot2
        active = active & ~won
    return tk.TicketTable(nk, nt, table.key_by_ticket, table.count, table.overflowed)


def grow_bound(
    table: tk.TicketTable, new_max_groups: int, load_factor: float = 0.5, *,
    relocate=None,
) -> tk.TicketTable:
    """Widen ``max_groups`` (the ``key_by_ticket`` length) to
    ``new_max_groups``, migrating the probe table if the capacity rule
    demands more slots for the new bound.  ``relocate(table,
    new_capacity)`` does the migration (default :func:`migrate`; the
    engine passes ``kernels.table_ops.migrate``, the card's kernel on CUDA
    tensors)."""
    if new_max_groups < table.max_groups:
        raise ValueError(
            f"grow_bound cannot shrink: {new_max_groups} < {table.max_groups}"
        )
    if new_max_groups > table.max_groups:
        pad = table.key_by_ticket.new_full(
            (new_max_groups - table.max_groups,), EMPTY_I32
        )
        table = tk.TicketTable(
            table.keys, table.tickets,
            torch.cat([table.key_by_ticket, pad]),
            table.count, table.overflowed,
        )
    cap_needed = table_capacity(new_max_groups, load_factor)
    if cap_needed > table.capacity:
        table = (relocate or migrate)(table, cap_needed)
    return table


def table_nbytes(table: tk.TicketTable) -> int:
    """Device bytes one ticket table holds."""
    return int(sum(t.numel() * t.element_size() for t in table))


def maybe_resize(table: tk.TicketTable, load_factor: float = 0.5, *,
                 relocate=None) -> tk.TicketTable:
    """Host-side growth check between morsels (the host pipeline's resize
    point): double the capacity once the count passes the load factor
    (``relocate`` as in :func:`grow_bound`)."""
    if int(table.count) > load_factor * table.capacity:
        return (relocate or migrate)(table, 2 * table.capacity)
    return table
