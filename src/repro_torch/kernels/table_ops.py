"""GET_OR_INSERT into a carried table, lookup and migration on the card.

Card counterparts of the reference's three device-side table loops, each
one ``jax.lax.while_loop`` program there:

* :func:`get_or_insert` — ``repro.core.ticketing.get_or_insert``
  (``src/repro/core/ticketing.py:82``, claim rounds at :199 / :203): n key
  bit patterns into a carried :class:`~repro_torch.core.ticketing.
  TicketTable`; known keys keep their tickets, new ones take gap-free
  tickets past the count (which may pass G; ``key_by_ticket`` gets t <= G
  only), the sticky ``overflowed`` flag is set past G, and a row not
  placed (a saturated table) and an EMPTY row get -1.  On CUDA tensors it
  is ``scan_ticket_kernel`` (``csrc/fused_groupby.cu``) in unchecked mode
  over the keys cut into morsels of :data:`MORSEL_ROWS`: unchecked, that
  kernel has this contract (no room check, every morsel commits).
* :func:`lookup` — ``repro.core.ticketing.lookup`` (:213, loop :237): the
  read-only probe, ``csrc/table_ops.cu`` on one of two paths.  A table of
  at most :data:`LOOKUP_SHARED_SLOTS` slots is copied into each CTA's
  shared memory and probed there (``lookup_shared_kernel``); a larger one
  is probed in device memory with several rows a thread, each row's home
  slot (ticket and key word) loaded before any compare
  (``lookup_probe_kernel``).
* :func:`migrate` — ``repro.core.resize.migrate`` (``core/resize.py:34``,
  loop :73): every (key, ticket) pair relocated into C' slots,
  ``key_by_ticket``, count and flag kept.  Into more slots, and at least
  :data:`MIGRATE_TILE_SLOTS`, a CTA builds each tile of new slots in
  shared memory from the old range that holds its keys and stores it
  whole, and a second launch places the keys that ran past a tile's end
  (``migrate_tiled_kernel``, ``migrate_overflow_kernel``); no fill pass.
  Into as many or fewer slots, or into a table smaller than one tile, a
  fill and one thread an old slot (``migrate_slot_kernel``).

Each wrapper launches its kernel for CUDA tensors (built at first use,
counted in ``<wrapper>.launches``; :func:`lookup` and :func:`migrate`
also count each path in ``<wrapper>.paths``) and raises if it cannot; for CPU
tensors it runs the plain version, the port's ``core.ticketing`` /
``core.resize`` function, which matches the reference bit for bit.  No
wrapper reads the card from the host, except :func:`migrate` into fewer
slots than the table has (below).

:func:`get_or_insert` updates ``table`` IN PLACE on every device and
returns it (the plain version is pure; its result is copied back), as
``scan_ticket`` does: a caller that keeps the table as it was passes a
clone.  :func:`lookup` and :func:`migrate` leave it as it is.

The kernels race on the table with atomics, so ticket order and slot
placement vary from run to run: :func:`table_map_discrepancies` holds a
kernel's table to the plain version's as a map.  :func:`lookup` reads a
table nothing writes, and equals the plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import EMPTY_I32, slot_hash

MORSEL_ROWS = 4096  # rows a scan_ticket morsel takes in get_or_insert
# lookup probes in shared memory up to this many slots, past it in device
# memory: on an H100 the shared path was faster at every size it takes
# (table_ops_max_shared_slots(), 2^14 slots; tools/kernel_turns.py's
# table_lookup_paths)
LOOKUP_SHARED_SLOTS = 1 << 14
MIGRATE_TILE_SLOTS = 2048  # new slots a CTA of the tiled migration (table_ops_tile_slots())
_INT32_MAX = 0x7FFFFFFF


def _device_of(table: tk.TicketTable, keys: torch.Tensor | None = None) -> torch.device:
    dev = table.keys.device
    if keys is not None and keys.device != dev:
        raise ValueError(f"keys lie on {keys.device}, the table on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the table ops run on cuda or cpu tensors, not {dev}")
    return dev


def _flat_keys(keys: torch.Tensor) -> torch.Tensor:
    flat = keys.reshape(-1)
    if flat.dtype != torch.int32:
        flat = flat.to(torch.int32)
    return flat.contiguous()


def _check_table(table: tk.TicketTable) -> None:
    for name, t in (("keys", table.keys), ("tickets", table.tickets)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != table.keys.device:
            raise ValueError(f"table {name} must be contiguous int32 on {table.keys.device}, "
                             f"got {t.dtype} on {t.device}")
    c = table.capacity
    if c & (c - 1) or tuple(table.tickets.shape) != (c,) or c > _INT32_MAX:
        raise ValueError(f"inconsistent table of {c} slots")


def get_or_insert(table: tk.TicketTable, keys: torch.Tensor):
    """GET_OR_INSERT of ``keys`` (int32 bit patterns, any shape) into
    ``table``, updated in place.  Returns ``(tickets, table)``: 0-based
    int32 tickets of the keys' shape, -1 for EMPTY rows and for rows not
    placed in a saturated table."""
    dev = _device_of(table, keys)
    if dev.type == "cpu":
        tickets, new = tk.get_or_insert(table, keys)
        for dst, src in zip(table, new):
            dst.copy_(src)
        return tickets, table
    from repro_torch.kernels import fused_groupby as fk

    flat = _flat_keys(keys)
    n = flat.shape[0]
    if n == 0:
        return torch.empty(keys.shape, dtype=torch.int32, device=dev), table
    m = min(MORSEL_ROWS, n)
    npm = -(-n // m)
    if npm * m != n:
        padded = flat.new_full((npm * m,), EMPTY_I32)
        padded[:n] = flat
        flat = padded
    todo = torch.ones((npm,), dtype=torch.int32, device=dev)
    call = fk.prepare_scan_ticket(table, flat.view(npm, m), todo, checked=False)
    tickets, _ = fk.launch_scan_ticket(call, counter=get_or_insert)
    return tickets.reshape(-1)[:n].reshape(keys.shape), table


get_or_insert.launches = 0  # kernel launches (CUDA tensors only)
get_or_insert.grid = None   # (CTAs, CTAs) of the latest launch


def lookup(table: tk.TicketTable, keys: torch.Tensor) -> torch.Tensor:
    """Read-only probe of ``keys`` (int32 bit patterns, any shape): their
    0-based tickets, -1 for EMPTY and absent keys.  A probe stops at an
    empty slot or after ``capacity`` slots."""
    dev = _device_of(table, keys)
    if dev.type == "cpu":
        return tk.lookup(table, keys)
    _check_table(table)
    flat = _flat_keys(keys)
    out = torch.empty(flat.shape, dtype=torch.int32, device=dev)
    if flat.shape[0] == 0:
        return out.reshape(keys.shape)
    path = lookup_path(table.capacity)
    _launch_lookup(table, flat, out, path)
    lookup.launches += 1
    lookup.paths[path] += 1
    return out.reshape(keys.shape)


lookup.launches = 0  # kernel launches (CUDA tensors only)
lookup.paths = {"shared": 0, "probe": 0}  # launches by path

_LOOKUP_MODES = {"shared": 0, "probe": 1}


def lookup_path(capacity: int) -> str:
    """The lookup kernel's path for a table of ``capacity`` slots."""
    return "shared" if capacity <= LOOKUP_SHARED_SLOTS else "probe"


def _launch_lookup(table: tk.TicketTable, flat: torch.Tensor, out: torch.Tensor,
                   path: str) -> None:
    """One launch of the lookup kernel on ``path`` (uncounted: the wrapper
    counts; ``tools/kernel_turns.py`` times each path through this)."""
    lib = _library()
    err = lib.table_lookup_launch(
        flat.data_ptr(), flat.shape[0], table.keys.data_ptr(), table.tickets.data_ptr(),
        table.capacity, out.data_ptr(), _LOOKUP_MODES[path],
        torch._C._cuda_getCurrentRawStream(out.device.index))
    if err != 0:
        raise RuntimeError("table lookup kernel launch failed: "
                           + lib.table_ops_error_string(err).decode())


def migrate(table: tk.TicketTable, new_capacity: int) -> tk.TicketTable:
    """Relocate every (key, ticket) pair of ``table`` into a new table of
    ``new_capacity`` slots (a power of two); ``key_by_ticket``, the count
    and the flag are kept (the same tensors).  On the card the new table is
    written whole by the call.  A key that finds no slot raises: that can
    only happen when ``new_capacity`` is below the live count, so only a
    migration into fewer slots than the table has reads the card's error
    flag (one host sync); a grow never does."""
    if new_capacity < 1 or new_capacity & (new_capacity - 1):
        raise ValueError(f"new_capacity must be a power of 2, got {new_capacity}")
    dev = _device_of(table)
    if dev.type == "cpu":
        return resize.migrate(table, new_capacity)
    _check_table(table)
    if new_capacity > _INT32_MAX:
        raise ValueError(f"new_capacity={new_capacity} does not fit int32")
    path = migrate_path(table.capacity, new_capacity)
    nk = torch.empty((new_capacity,), dtype=torch.int32, device=dev)
    nt = torch.empty((new_capacity,), dtype=torch.int32, device=dev)
    aux = torch.empty((2,), dtype=torch.int32, device=dev)  # error flag, overflow count
    ovf = (torch.empty((table.capacity,), dtype=torch.int32, device=dev)
           if path == "tiled" else None)
    lib = _library()
    err = lib.table_migrate_launch(
        table.keys.data_ptr(), table.tickets.data_ptr(), table.capacity, nk.data_ptr(),
        nt.data_ptr(), new_capacity, aux.data_ptr(), None if ovf is None else ovf.data_ptr(),
        int(path == "tiled"), torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError("table migrate kernel launch failed: "
                           + lib.table_ops_error_string(err).decode())
    migrate.launches += 1
    migrate.paths[path] += 1
    if new_capacity < table.capacity and int(aux[0]) != 0:
        raise RuntimeError(f"migrate: the table's keys do not fit {new_capacity} slots")
    return tk.TicketTable(nk, nt, table.key_by_ticket, table.count, table.overflowed)


migrate.launches = 0  # kernel launches (CUDA tensors only)
migrate.paths = {"tiled": 0, "slot": 0}  # launches by path


def migrate_path(capacity: int, new_capacity: int) -> str:
    """The migration kernel's path from ``capacity`` into ``new_capacity``
    slots: ``"tiled"`` for a grow into at least one tile, else ``"slot"``."""
    return "tiled" if new_capacity > capacity and new_capacity >= MIGRATE_TILE_SLOTS else "slot"


_LIB = None  # the loaded library, bound once by _library


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build

        lib = build.load_library("table_ops")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.table_lookup_launch.argtypes = [ptr, i64, ptr, ptr, i32, ptr, i32, ptr]
        lib.table_lookup_launch.restype = i32
        lib.table_migrate_launch.argtypes = [ptr, ptr, i64, ptr, ptr, i32, ptr, ptr, i32, ptr]
        lib.table_migrate_launch.restype = i32
        for name in ("table_ops_tile_slots", "table_ops_max_shared_slots"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.table_ops_error_string.argtypes = [i32]
        lib.table_ops_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def unreachable_slots(table: tk.TicketTable) -> torch.Tensor:
    """``(capacity,)`` bool: the occupied slots whose key a probe from its
    home slot cannot reach, because an empty slot lies between."""
    c = table.capacity
    occ = table.tickets > 0
    if bool(occ.all()):
        return torch.zeros_like(occ)
    idx = torch.arange(c, device=occ.device)
    empty_at = torch.where(occ, torch.full_like(idx, -1), idx)
    last = torch.cummax(empty_at, 0).values  # the nearest empty slot at or before
    last = torch.where(last < 0, empty_at.max() - c, last)  # ... cyclically
    dist = (idx - slot_hash(table.keys, c)) & (c - 1)  # slots probed before this one
    return occ & (dist >= idx - last)


def table_map_discrepancies(out: tk.TicketTable, ref: tk.TicketTable, *,
                            known: int | None = None, keys: torch.Tensor | None = None,
                            tickets=None, full: bool = False) -> int:
    """How far ``out`` (a table a kernel wrote) breaks the contract with
    ``ref`` (the plain version's table from the same input); 0 when it
    keeps it.  ``known`` is the count before the call: tickets 1..known
    belong to keys that were in the table and keep them (default: ref's
    count, a migration).  ``keys`` and ``tickets`` (``(out's, ref's)``) are
    a :func:`get_or_insert`'s rows and each version's tickets.  ``full``:
    the call saturated the table, so which new keys found a slot depends on
    the order of the claims.

    Counted: |Δcount| and a differing ``overflowed``; occupied slots that
    hold EMPTY; table tickets that are not exactly 1..count (each missing,
    duplicated or out of range); keys held by more than one slot; slots
    whose ticket t <= G does not name their key in ``key_by_ticket``, and
    entries past min(count, G) that are not EMPTY; keys behind an empty
    slot from their home slot; ref's known keys that ``out`` lacks or
    tickets otherwise, and its new keys that ``out`` tickets at or below
    ``known``; and, unless ``full``, keys in one table only.  Rows: tickets
    on EMPTY rows, resolved rows whose ticket is past the count or names
    another key, and rows resolved differently from ``ref`` (when ``full``:
    rows left -1 whose key is in the table and resolved rows whose key is
    not)."""
    n = int(out.count)
    bad = abs(n - int(ref.count)) + int(bool(out.overflowed) != bool(ref.overflowed))
    occ = out.tickets > 0
    tick, tkey = out.tickets[occ].long(), out.keys[occ]
    bad += int((tkey == EMPTY_I32).sum())
    hist = torch.bincount(tick.clamp(max=n + 1), minlength=n + 2)
    bad += int((hist[1:n + 1] - 1).abs().sum()) + int(hist[n + 1:].sum())
    _, per_key = torch.unique(tkey, return_counts=True)
    bad += int((per_key - 1).sum())
    g = out.max_groups
    inb = tick <= g
    bad += int((out.key_by_ticket[tick[inb] - 1] != tkey[inb]).sum())
    bad += int((out.key_by_ticket[min(n, g):] != EMPTY_I32).sum())
    bad += int(unreachable_slots(out).sum())

    known = int(ref.count) if known is None else known
    rocc = ref.tickets > 0
    rkey, rtick = ref.keys[rocc], ref.tickets[rocc].long()
    order = torch.argsort(tkey)
    skey, stick = tkey[order], tick[order]
    if skey.numel():
        at = torch.searchsorted(skey, rkey).clamp(max=skey.numel() - 1)
        found = skey[at] == rkey
        got = torch.where(found, stick[at], torch.zeros_like(rtick))
    else:
        found, got = torch.zeros_like(rkey, dtype=torch.bool), torch.zeros_like(rtick)
    old = rtick <= known
    bad += int((old & (got != rtick)).sum())
    bad += int((~old & found & (got <= known)).sum())
    if not full:
        bad += int((~old & ~found).sum()) + int((~torch.isin(tkey, rkey)).sum())

    if keys is not None:
        kt, pt = (t.reshape(-1) for t in tickets)
        keys = keys.reshape(-1).to(torch.int32)
        valid = keys != EMPTY_I32
        ok = kt >= 0
        bad += int((ok & ~valid).sum())
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
            bad += int((ok != (pt >= 0)).sum())
    return bad


def keys_with_home(home: int, capacity: int, count: int, start: int = 1 << 30) -> torch.Tensor:
    """The ``count`` smallest int32 keys from ``start`` on (CPU) whose home
    slot in ``capacity`` slots is ``home``."""
    found, lo, step = [], start, 1 << 22
    while sum(f.numel() for f in found) < count:
        cand = torch.arange(lo, lo + step, dtype=torch.int64).to(torch.int32)
        found.append(cand[slot_hash(cand, capacity) == home])
        lo += step
    return torch.cat(found)[:count]


# name → (capacity, random keys, (home, keys homed there) or None); G = capacity
EDGE_CASES = {
    # a cluster of 100 keys from slot C - 3 wraps from C - 1 to 0, in the old
    # table and at the last tile of every new one
    "wrap": (8192, 2000, (8192 - 3, 100)),
    # 300 keys share home 4088, 8 slots before a tile's end at every ratio:
    # each new home's share overflows into the next tile
    "shared_home": (8192, 2000, (4096 - 8, 300)),
    "full": (8192, 8192, None),  # every slot taken: no ticket-0 slot to stop a scan
    "small": (64, 30, None),  # grows into fewer slots than one tile
    "plain": (8192, 4096, None),  # load 1/2
    # lookup just under and just over the shared-memory threshold, at load 1/2
    "shared_edge": (LOOKUP_SHARED_SLOTS, LOOKUP_SHARED_SLOTS // 2, None),
    "past_shared": (2 * LOOKUP_SHARED_SLOTS, LOOKUP_SHARED_SLOTS, None),
}
EDGE_RATIOS = (2, 4, 16)


def edge_case_table(name: str, device=None):
    """``(table, probe)`` of :data:`EDGE_CASES` ``name``: a table built by
    the plain GET_OR_INSERT on ``device`` (the same on every device), and
    probe keys, its keys, absent keys (some homed in its longest cluster)
    and EMPTY rows.  Seeded, so every caller gets the same table."""
    cap, n_random, homed = EDGE_CASES[name]
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    keys = (torch.randperm(1 << 22, generator=gen)[:n_random] * 7 + 12345).to(torch.int32)
    absent = (torch.randperm(1 << 22, generator=gen)[:64] * 7 + 12346).to(torch.int32)
    if homed is not None:
        home, count = homed
        near = keys_with_home(home, cap, count + 16)
        keys, absent = torch.cat([near[:count], keys]), torch.cat([near[count:], absent])
    if name == "full":
        keys = keys[:cap]
    table = tk.make_table(cap, cap, device=device)
    _, table = tk.get_or_insert(table, keys.to(device))
    empty = torch.full((8,), EMPTY_I32, dtype=torch.int32)
    probe = torch.cat([keys, absent, empty])[torch.randperm(keys.numel() + 72, generator=gen)]
    return table, probe.to(device)
