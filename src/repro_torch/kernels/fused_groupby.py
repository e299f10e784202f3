"""Fused ticketing + aggregate update: the ``kernel="fused"`` route.

Port of ``repro.kernels.fused_groupby``.  One launch consumes a morselized
chunk against carried state (``FusedState``: one local probe table,
``key_by_ticket`` and S accumulator planes per program, plus the event
vector), tickets every morsel whose ``todo`` flag is set and folds it into
the accumulators, clears the flag of each morsel it commits, and reports
the §4.4 control signals in a ``(P, INFO_LEN)`` info vector that the
executor reads once per chunk.  The morsels left todo (paused, or
saturated under ``checked``) are replayed by relaunching on the same mask.

:func:`fused_consume` is the wrapper.  For CUDA tensors it launches the
hand-written Hopper kernel ``csrc/fused_groupby.cu`` (built at first use,
``kernels/build.py``) on CTAs that fill the card, and raises if it cannot;
for CPU tensors it runs :func:`fused_consume_plain`, a PyTorch
implementation of the Pallas kernel's exact protocol (claim rounds, lowest
lane wins, tickets ranked by a cumulative sum, at most ``2C + 2`` rounds,
morsels in order) that matches the JAX kernel ticket for ticket when the
mask is :func:`todo_from_start`.  Both update ``state`` and ``todo`` IN
PLACE — unlike the JAX kernel, which returns new arrays — so a launch never
copies the table.  :func:`grow_fused_state` and :func:`merge_fused_state`
return new tensors and never mutate their input.

The kernel's CTAs race on one table and take morsels in no fixed order, so
its ticket order, float-sum order and — when a launch pauses or saturates
— its set of committed morsels vary from run to run.  It agrees with the
plain version on the group count, the key set, COUNT/MIN/MAX exactly and
SUM within float tolerance, gap-free tickets consistent with
``key_by_ticket``, and on the info vector and the event counts (probe steps
aside: the kernel has no claim rounds) of every launch that commits all its
morsels.

:func:`scan_ticket` is the scan route's ticket stage: the same morsel
dispatch and room check (one program, no accumulator planes) in a kernel
of its own, ``scan_ticket_kernel``, that tickets each morsel in tiles
through a per-CTA key cache with one count atomic per tile, against a
carried :class:`~repro_torch.core.ticketing.TicketTable`, updated in place,
and writes each row's ticket for the morsels it commits and -1 for every
other row.  Its plain version is
:func:`fused_consume_plain` with S = 0 and the same ticket output; the
per-morsel step of the plain version is the scan route's own
``engine.groupby.make_pause_scan_body``.

:func:`scan_ticket_batched` is the serving layer's round: N lanes, each
one query's chunk against that query's table, in one launch of
``scan_ticket_batched_kernel`` (the same per-CTA body, each lane's CTAs on
its own table) with one ``(N, INFO_LEN)`` info tensor.  Given the lanes'
accumulator states it also folds every committed morsel into them (fold
mode, the reference's ``_batched_consume``: ticket and update in one
dispatch); without them it returns the tickets.  Its plain version runs
:func:`scan_ticket_plain`, and then the scatter update, lane by lane.
"""
from __future__ import annotations

import array
import ctypes
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32, table_capacity, to_i32_bits
from repro_torch.engine.groupby import make_pause_scan_body, make_unchecked_scan_body
from repro_torch.obs import metrics as obs_metrics

_NEUTRAL = {"sum": 0.0, "count": 0.0, "min": float("inf"), "max": float("-inf")}
_KIND_CODE = {"sum": 0, "count": 1, "min": 2, "max": 3}

# Control-signal layout of the per-program info vector: issued-ticket
# count, the lowest morsel still todo after the launch (NO_HALT when it
# committed every morsel; the reference's first halted morsel), the
# launch's probe-saturation flag, and the halted bit (a morsel is todo).
INFO_COUNT = 0
INFO_FIRST_HALT = 1
INFO_SAT = 2
INFO_HALTED = 3
INFO_LEN = 4
NO_HALT = 0x7FFFFFFF

MAX_SPECS = 16          # accumulator planes the kernel takes (csrc kMaxSpecs)
MAX_MORSEL_ROWS = 4096  # 1 int of shared memory per row, beside the fold table
BLOCK_THREADS = 256     # threads per CTA of the kernel (a multiple of 32)
SCAN_BLOCK_THREADS = 512  # threads per CTA of scan_ticket's kernel: 256, 512 or 1024
_INT32_MAX = 0x7FFFFFFF


class FusedState(NamedTuple):
    """Carried state of the fused route: one local table + accumulator
    block per program, plus the cumulative event vector.

    Attributes:
      tkeys:  (P, C) int32 — probe-table keys (EMPTY_I32 where free).
      ttks:   (P, C) int32 — 1-based tickets, 0 where free.
      kbt:    (P, G) int32 — keys in local ticket order.
      accs:   (S, P, G) float32 — one raw partial per expanded agg spec.
      count:  (P,) int32 — local tickets issued.
      events: (P, EVENT_VEC_LEN) int32 — event vector per program.
    """

    tkeys: torch.Tensor
    ttks: torch.Tensor
    kbt: torch.Tensor
    accs: torch.Tensor
    count: torch.Tensor
    events: torch.Tensor

    @property
    def programs(self) -> int:
        return self.tkeys.shape[0]

    @property
    def capacity(self) -> int:
        return self.tkeys.shape[1]

    @property
    def max_groups(self) -> int:
        return self.kbt.shape[1]

    @property
    def device(self) -> torch.device:
        return self.tkeys.device

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self))


def init_fused_state(
    *, capacity: int, max_groups: int, kinds: tuple, programs: int = 1, device=None
) -> FusedState:
    """Fresh empty state: ``programs`` local tables of ``capacity`` slots
    (a power of two), a ``max_groups`` ticket bound each, and one
    neutral-filled accumulator plane per agg kind."""
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of 2, got {capacity}")
    accs = torch.empty((len(kinds), programs, max_groups), dtype=torch.float32,
                       device=device)
    for s, k in enumerate(kinds):
        accs[s].fill_(_NEUTRAL[k])
    return FusedState(
        tkeys=torch.full((programs, capacity), EMPTY_I32, dtype=torch.int32, device=device),
        ttks=torch.zeros((programs, capacity), dtype=torch.int32, device=device),
        kbt=torch.full((programs, max_groups), EMPTY_I32, dtype=torch.int32, device=device),
        accs=accs,
        count=torch.zeros((programs,), dtype=torch.int32, device=device),
        events=torch.zeros((programs, obs_metrics.EVENT_VEC_LEN), dtype=torch.int32,
                           device=device),
    )


def program_table(state: FusedState, p: int) -> tk.TicketTable:
    """One program's local table as a :class:`~repro_torch.core.ticketing.
    TicketTable` (views of the state: the layouts match exactly)."""
    return tk.TicketTable(
        keys=state.tkeys[p],
        tickets=state.ttks[p],
        key_by_ticket=state.kbt[p],
        count=state.count[p],
        overflowed=state.count[p] > state.max_groups,
    )


def grow_fused_state(
    state: FusedState,
    kinds: tuple,
    *,
    new_max_groups: int | None = None,
    new_capacity: int | None = None,
    load_factor: float = 0.5,
) -> FusedState:
    """§4.4 growth at a pause boundary: widen every local bound
    (``resize.grow_bound``) and/or migrate its probe slots
    (``resize.migrate``; tickets are immutable, so the key→ticket map is
    kept exactly), padding the accumulators with per-kind neutrals.
    Returns a new state; ``state`` is not modified."""
    tables = []
    for p in range(state.programs):
        t = program_table(state, p)
        t = t._replace(overflowed=torch.zeros((), dtype=torch.bool, device=state.device))
        if new_max_groups is not None and new_max_groups > t.max_groups:
            t = resize.grow_bound(t, new_max_groups, load_factor)
        if new_capacity is not None and new_capacity > t.capacity:
            t = resize.migrate(t, new_capacity)
        tables.append(t)
    g_new = tables[0].max_groups
    accs = state.accs.clone()
    pad = g_new - state.max_groups
    if pad > 0:
        fill = torch.empty((len(kinds), state.programs, pad), dtype=torch.float32,
                           device=state.device)
        for s, k in enumerate(kinds):
            fill[s].fill_(_NEUTRAL[k])
        accs = torch.cat([accs, fill], dim=2)
    return FusedState(
        tkeys=torch.stack([t.keys for t in tables]),
        ttks=torch.stack([t.tickets for t in tables]),
        kbt=torch.stack([t.key_by_ticket for t in tables]),
        accs=accs,
        count=state.count.clone(),
        events=state.events.clone(),
    )


def merge_fused_state(
    state: FusedState, kinds: tuple, *, max_groups: int | None = None,
    load_factor: float = 0.5,
):
    """Second-level merge: fold the P local (key_by_ticket, accs) partials
    into ONE global ticket space.  Pure (fresh tensors, ``state`` is not
    modified), so ``snapshot()`` may call it repeatedly while the kernel
    keeps updating the state in place.

    Returns ``(table, accs)``: a global :class:`TicketTable` and a list of
    ``(max_groups,)`` raw partials aligned with ``kinds``.  With a single
    program the local state IS the global state (cloned, native order)."""
    if max_groups is None:
        max_groups = state.max_groups
    if state.programs == 1 and max_groups == state.max_groups:
        t = program_table(state, 0)
        table = tk.TicketTable(*(x.clone() for x in t))
        return table, [state.accs[s, 0].clone() for s in range(len(kinds))]
    dev = state.device
    table = tk.make_table(table_capacity(max_groups, load_factor), max_groups,
                          device=dev)
    accs = [torch.full((max_groups + 1,), _NEUTRAL[k], dtype=torch.float32, device=dev)
            for k in kinds]  # slot max_groups parks dropped entries
    for p in range(state.programs):
        tickets, table = tk.get_or_insert(table, state.kbt[p])
        ok = tickets >= 0
        idx = torch.where(ok, tickets, torch.full_like(tickets, max_groups)).to(torch.int64)
        for s, k in enumerate(kinds):
            vv = torch.where(ok, state.accs[s, p],
                             torch.full_like(state.accs[s, p], _NEUTRAL[k]))
            if k in ("sum", "count"):
                accs[s].index_add_(0, idx, vv)
            else:
                accs[s].scatter_reduce_(0, idx, vv, "amin" if k == "min" else "amax")
    return table, [a[:max_groups] for a in accs]


def todo_from_start(P: int, npm: int, start, device=None) -> torch.Tensor:
    """The ``(P·npm,)`` int32 todo mask of the reference's resume points:
    morsel ``i`` of program ``p`` is todo iff ``i >= start[p]``."""
    start = torch.as_tensor(start, dtype=torch.int32, device=device).reshape(P, 1)
    i = torch.arange(npm, dtype=torch.int32, device=start.device)
    return (i >= start).to(torch.int32).reshape(-1).contiguous()


def _check_launch(state: FusedState, keys, values, todo, specs, tickets_out=None) -> None:
    """Device, dtype, shape and contiguity checks shared by both paths."""
    dev = keys.device
    checks = [
        ("keys", keys, torch.int32), ("values", values, torch.float32),
        ("todo", todo, torch.int32), ("tkeys", state.tkeys, torch.int32),
        ("ttks", state.ttks, torch.int32), ("kbt", state.kbt, torch.int32),
        ("accs", state.accs, torch.float32), ("count", state.count, torch.int32),
        ("events", state.events, torch.int32),
    ]
    if tickets_out is not None:
        checks.append(("tickets_out", tickets_out, torch.int32))
        if tickets_out.shape != keys.shape:
            raise ValueError(f"tickets_out {tuple(tickets_out.shape)} is not the keys' "
                             f"{tuple(keys.shape)}")
    for name, t, dtype in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, keys on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P, C = state.tkeys.shape
    S, p_accs, G = state.accs.shape
    if keys.dim() != 2 or values.dim() != 3:
        raise ValueError("keys must be (P*npm, M) and values (V, P*npm, M)")
    V, total, M = values.shape
    if tuple(keys.shape) != (total, M) or total % P:
        raise ValueError(
            f"keys {tuple(keys.shape)} / values {tuple(values.shape)} do not "
            f"split into {P} programs of M-row morsels"
        )
    if (tuple(state.ttks.shape) != (P, C) or tuple(state.kbt.shape) != (P, G)
            or p_accs != P or tuple(state.count.shape) != (P,)
            or tuple(state.events.shape) != (P, obs_metrics.EVENT_VEC_LEN)
            or tuple(todo.shape) != (total,)):
        raise ValueError("inconsistent FusedState / todo shapes")
    if C & (C - 1):
        raise ValueError(f"capacity must be a power of 2, got {C}")
    if len(specs) != S or not 0 <= S <= MAX_SPECS:
        raise ValueError(f"{len(specs)} specs for {S} accumulator planes (max {MAX_SPECS})")
    for plane, kind in specs:
        if kind not in _KIND_CODE or not -1 <= plane < V:
            raise ValueError(f"bad spec {(plane, kind)} for {V} value planes")


def fused_consume(
    state: FusedState,
    keys: torch.Tensor,    # (P * npm, M) int32, EMPTY_I32-padded
    values: torch.Tensor,  # (V, P * npm, M) float32
    todo: torch.Tensor,    # (P * npm,) int32 — 1: morsel still to commit
    *,
    specs: tuple,
    checked: bool = True,
    grow_bound: bool = True,
    threshold: int = 0,
    bound_slack: int = 0,
    collect_events: bool = False,
):
    """One fused pass over a morselized chunk; ``state`` and ``todo`` are
    updated in place.  Program ``p`` owns morsels ``[p*npm, (p+1)*npm)``
    and commits those whose ``todo`` flag is set, clearing the flag of each
    one it commits.  Returns ``(state, info)`` with ``info`` the
    ``(P, INFO_LEN)`` control vector.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_consume.launches``; its ``(CTAs, CTAs per program)`` kept in
    ``fused_consume.grid``); CPU tensors run :func:`fused_consume_plain`;
    any other device raises."""
    _check_launch(state, keys, values, todo, specs)
    dev = keys.device
    if dev.type == "cpu":
        return fused_consume_plain(
            state, keys, values, todo, specs=specs, checked=checked,
            grow_bound=grow_bound, threshold=threshold,
            bound_slack=bound_slack, collect_events=collect_events,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_consume runs on cuda or cpu tensors, not {dev}")
    for name, v in (("threshold", threshold), ("bound_slack", bound_slack)):
        if not -_INT32_MAX <= v <= _INT32_MAX:
            raise ValueError(f"{name}={v} does not fit int32")
    P, C = state.tkeys.shape
    S, _, G = state.accs.shape
    _, total, M = values.shape
    if S == 0:
        raise ValueError("the fused kernel takes 1..MAX_SPECS accumulator planes; "
                         "scan_ticket tickets without any")
    if M > MAX_MORSEL_ROWS:
        raise ValueError(f"morsel of {M} rows exceeds the kernel's {MAX_MORSEL_ROWS}")
    info = torch.empty((P, INFO_LEN), dtype=torch.int32, device=dev)
    # per-launch scratch: morsel counter, finished CTAs, saturation flag,
    # and the reserved tickets, which start at the count
    scratch = torch.zeros((P, 4), dtype=torch.int32, device=dev)
    scratch[:, 3] = state.count
    planes = (ctypes.c_int * S)(*[int(p) for p, _ in specs])
    kinds = (ctypes.c_int * S)(*[_KIND_CODE[k] for _, k in specs])
    grid = (ctypes.c_int * 2)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _kernel_library()
    err = lib.fused_groupby_launch(
        keys.data_ptr(), values.data_ptr(), todo.data_ptr(),
        state.tkeys.data_ptr(), state.ttks.data_ptr(), state.kbt.data_ptr(),
        state.accs.data_ptr(), state.count.data_ptr(), state.events.data_ptr(),
        info.data_ptr(), scratch.data_ptr(), planes, kinds, S, P, total // P, M, C, G,
        int(checked), int(grow_bound), int(threshold), int(bound_slack),
        int(collect_events), BLOCK_THREADS, grid, stream,
    )
    if err != 0:
        raise RuntimeError(
            "fused_groupby kernel launch failed: "
            + lib.fused_groupby_error_string(err).decode()
        )
    fused_consume.launches += 1
    fused_consume.grid = (grid[0], grid[1])
    return state, info


fused_consume.launches = 0  # kernel launches (CUDA tensors only)
fused_consume.grid = None   # (CTAs, CTAs per program) of the latest launch


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("fused_groupby")
    fn = lib.fused_groupby_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ptr] * 11 + [ints, ints] + [i32] * 12 + [ints, ptr]
        fn.restype = ctypes.c_int
        lib.fused_groupby_error_string.argtypes = [ctypes.c_int]
        lib.fused_groupby_error_string.restype = ctypes.c_char_p
        scan = lib.scan_ticket_launch
        scan.argtypes = [ptr] * 11 + [i32] * 10 + [ints, ptr]
        scan.restype = ctypes.c_int
        batched = lib.scan_ticket_batched_launch
        batched.argtypes = [ptr] + [i32] * 3 + [ptr] * 2 + [i32] * 4 + [ints, ptr]
        batched.restype = ctypes.c_int
    return lib


def fused_consume_plain(
    state: FusedState,
    keys: torch.Tensor,
    values: torch.Tensor,
    todo: torch.Tensor,
    *,
    specs: tuple,
    checked: bool = True,
    grow_bound: bool = True,
    threshold: int = 0,
    bound_slack: int = 0,
    collect_events: bool = False,
    tickets_out: torch.Tensor | None = None,
):
    """The plain PyTorch version of the fused kernel: the Pallas kernel's
    protocol step for step, on any device, updating ``state`` and ``todo``
    in place.  Each program runs its todo morsels in order through the scan
    route's per-morsel body (``engine.groupby.make_pause_scan_body``, or
    the unchecked body): room check, ``core.ticketing.get_or_insert`` claim
    rounds, and a fold of the committed rows into the S accumulator planes.
    At its first pause (or saturation under ``checked``) a program leaves
    that morsel and every later one todo — the kernel's rule with one CTA.
    ``tickets_out`` (the keys' shape, filled with -1 by the caller) gets
    the 0-based tickets of every committed morsel: with S = 0 this is
    :func:`scan_ticket`'s plain version.  With ``todo_from_start(P, npm,
    start)`` it matches JAX ``fused_consume(..., start, interpret=True)``
    ticket for ticket."""
    _check_launch(state, keys, values, todo, specs, tickets_out)
    dev = keys.device
    P = state.programs
    S, _, G = state.accs.shape
    total, M = keys.shape
    npm = total // P
    info = torch.zeros((P, INFO_LEN), dtype=torch.int32, device=dev)
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    ones = torch.ones((M,), dtype=torch.float32, device=dev)
    flags = todo.reshape(P, npm).tolist()
    for p in range(P):

        def commit(accs_p, tickets, row):
            if tickets_out is not None:
                tickets_out[row] = tickets
            do = (tickets >= 0) & (tickets < G)
            t = tickets[do].to(torch.int64)
            for s, (plane, kind) in enumerate(specs):
                v = (ones if plane < 0 else values[plane, row])[do]
                if kind in ("sum", "count"):
                    accs_p[s].index_add_(0, t, v)
                else:
                    accs_p[s].scatter_reduce_(0, t, v, "amin" if kind == "min" else "amax")
            return accs_p

        if checked:
            body = make_pause_scan_body(0, threshold, bound_slack if grow_bound else None,
                                        commit, count_events=True)
        else:
            body = make_unchecked_scan_body(0, commit, count_events=True)
        table = tk.TicketTable(state.tkeys[p], state.ttks[p], state.kbt[p],
                               state.count[p].clone(), no_ovf)
        carry = (table, state.accs[:, p], False, obs_metrics.zero_event_vector(dev))
        for i in (i for i in range(npm) if flags[p][i]):
            row = p * npm + i
            carry, halt = body(carry, (i, keys[row], row))
            if halt:
                break
            flags[p][i] = 0
            todo[row] = 0
        table, _, halted, ev = carry
        state.tkeys[p].copy_(table.keys)
        state.ttks[p].copy_(table.tickets)
        state.kbt[p].copy_(table.key_by_ticket)
        count = int(table.count)
        state.count[p] = count
        if collect_events:
            state.events[p] += ev
        sat_any = int(ev[obs_metrics.EVT_PROBE_SATURATIONS] > 0)
        lowest = next((i for i in range(npm) if flags[p][i]), NO_HALT)
        info[p] = torch.tensor([count, lowest, sat_any, int(halted)], dtype=torch.int32)
    return state, info


def _table_view(table: tk.TicketTable, events: torch.Tensor) -> FusedState:
    """A one-program :class:`FusedState` of views of ``table`` (no copy) and
    no accumulator planes: what :func:`scan_ticket_plain` reads and
    updates."""
    return FusedState(
        tkeys=table.keys.view(1, -1), ttks=table.tickets.view(1, -1),
        kbt=table.key_by_ticket.view(1, -1),
        accs=torch.empty((0, 1, table.max_groups), dtype=torch.float32,
                         device=table.keys.device),
        count=table.count.view(1), events=events.view(1, -1),
    )


def scan_ticket(
    table: tk.TicketTable,
    keys: torch.Tensor,    # (npm, M) int32, EMPTY_I32-padded
    todo: torch.Tensor,    # (npm,) int32 — 1: morsel still to commit
    *,
    checked: bool = True,
    grow_bound: bool = False,
    threshold: int = 0,
    bound_slack: int = 0,
    collect_events: bool = False,
    events: torch.Tensor | None = None,
):
    """The scan route's ticket stage over a morselized chunk against the
    carried ``table`` (keys, tickets, ``key_by_ticket``, count and the
    sticky overflow flag updated IN PLACE) and ``todo`` (cleared for every
    morsel committed).  The §4.4 room check runs before each morsel:
    ``count > threshold``, and under ``grow_bound`` the morsel's
    reservation of M tickets must start at ``<= bound_slack``; a morsel
    that saturates the table commits nothing under ``checked``.

    Returns ``(tickets, info)``: ``tickets`` the keys' shape, each row's
    0-based ticket for the morsels this launch commits and -1 for every
    other row (padding, morsels not todo, paused, or saturated, even though
    some of their keys were inserted); ``info`` the fused route's ``(1,
    INFO_LEN)`` control vector.  ``events`` (``(EVENT_VEC_LEN,)`` int32,
    committed-morsel semantics) gains this launch's counts when
    ``collect_events``.

    CUDA tensors launch ``scan_ticket_kernel`` of ``csrc/fused_groupby.cu``
    (counted in ``scan_ticket.launches``; grid in ``scan_ticket.grid``) and
    raise if they cannot; its CTAs take morsels in no fixed order, so
    ticket order and, on a pause, the set of committed morsels vary from
    run to run, and a row answered from a CTA's key cache counts one probe
    step.  A morsel may have any number of rows there.  CPU tensors run
    :func:`scan_ticket_plain`: morsels in order, ticket for ticket the JAX
    scan route's."""
    dev = keys.device
    if dev.type == "cpu":
        return scan_ticket_plain(
            table, keys, todo, checked=checked, grow_bound=grow_bound,
            threshold=threshold, bound_slack=bound_slack,
            collect_events=collect_events, events=events,
        )
    call = prepare_scan_ticket(
        table, keys, todo, checked=checked, grow_bound=grow_bound, threshold=threshold,
        bound_slack=bound_slack, collect_events=collect_events, events=events,
    )
    return launch_scan_ticket(call)


_SCAN_SCRATCH = 4  # int32 words of launch scratch (csrc kScratch)


def prepare_scan_ticket(table, keys, todo, *, checked=True, grow_bound=False, threshold=0,
                        bound_slack=0, collect_events=False, events=None):
    """The host work of one :func:`scan_ticket` call on CUDA tensors: the
    checks, the tickets, and one small allocation holding the info vector
    and the launch scratch (the launcher fills the scratch on the card;
    the info vector, which the executor keeps until it polls, does not
    hold the tickets' memory).  :func:`launch_scan_ticket` runs the launch
    on it; the two split the call to time them apart."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"scan_ticket runs on cuda or cpu tensors, not {dev}")
    if events is None and collect_events:
        events = obs_metrics.zero_event_vector(dev)
    tensors = (keys, todo, table.keys, table.tickets, table.key_by_ticket, table.count,
               table.overflowed) + ((events,) if events is not None else ())
    for t, dtype in zip(tensors, (torch.int32,) * 6 + (torch.bool, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"scan_ticket takes contiguous {dtype} tensors on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if keys.dim() != 2 or tuple(todo.shape) != keys.shape[:1]:
        raise ValueError(f"keys {tuple(keys.shape)} / todo {tuple(todo.shape)} are not "
                         "(npm, M) / (npm,)")
    C = table.capacity
    if (C & (C - 1) or tuple(table.tickets.shape) != (C,) or table.count.numel() != 1
            or table.overflowed.numel() != 1
            or (events is not None and events.numel() != obs_metrics.EVENT_VEC_LEN)):
        raise ValueError("inconsistent TicketTable / events shapes")
    for name, v in (("threshold", threshold), ("bound_slack", bound_slack)):
        if not -_INT32_MAX <= v <= _INT32_MAX:
            raise ValueError(f"{name}={v} does not fit int32")
    npm, M = keys.shape
    if npm == 0:  # no morsel: nothing to launch, nothing todo
        info = torch.zeros((1, INFO_LEN), dtype=torch.int32, device=dev)
        info[0, INFO_COUNT] = table.count
        info[0, INFO_FIRST_HALT] = NO_HALT
        return keys.new_empty(keys.shape), info, None, ()
    tickets = torch.empty((npm, M), dtype=torch.int32, device=dev)
    aux = torch.empty((INFO_LEN + _SCAN_SCRATCH,), dtype=torch.int32, device=dev)
    args = (keys.data_ptr(), todo.data_ptr(), table.keys.data_ptr(), table.tickets.data_ptr(),
            table.key_by_ticket.data_ptr(), table.count.data_ptr(),
            events.data_ptr() if events is not None else None, aux.data_ptr(),
            aux.data_ptr() + 4 * INFO_LEN, tickets.data_ptr(), table.overflowed.data_ptr(),
            npm, M, C, table.max_groups, int(checked), int(grow_bound), int(threshold),
            int(bound_slack), int(collect_events))
    # the tensors behind the pointers stay referenced until the launch
    return tickets, aux[:INFO_LEN].view(1, INFO_LEN), args, (aux, tensors)


def launch_scan_ticket(call):
    """Launch the kernel on :func:`prepare_scan_ticket`'s call on the
    current stream (counted; a call with no morsel launches nothing) and
    return :func:`scan_ticket`'s ``(tickets, info)``.  Raises if the
    kernel cannot be built or launched."""
    tickets, info, args, _ = call
    if args is None:
        return tickets, info
    grid = (ctypes.c_int * 2)()
    lib = _kernel_library()
    err = lib.scan_ticket_launch(*args, SCAN_BLOCK_THREADS, grid,
                                 torch.cuda.current_stream(tickets.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "scan_ticket kernel launch failed: " + lib.fused_groupby_error_string(err).decode()
        )
    scan_ticket.launches += 1
    scan_ticket.grid = (grid[0], grid[1])
    return tickets, info


scan_ticket.launches = 0  # kernel launches (CUDA tensors only)
scan_ticket.grid = None   # (CTAs, CTAs per program) of the latest launch


def scan_ticket_plain(
    table: tk.TicketTable,
    keys: torch.Tensor,
    todo: torch.Tensor,
    *,
    checked: bool = True,
    grow_bound: bool = False,
    threshold: int = 0,
    bound_slack: int = 0,
    collect_events: bool = False,
    events: torch.Tensor | None = None,
):
    """The plain version of :func:`scan_ticket`, on any device, with its
    signature and in-place updates: :func:`fused_consume_plain` with S = 0
    on a one-program view of ``table``, writing the committed morsels'
    tickets."""
    dev = keys.device
    if events is None:
        events = obs_metrics.zero_event_vector(dev)
    state = _table_view(table, events)
    values = torch.empty((0, *keys.shape), dtype=torch.float32, device=dev)
    tickets = torch.full(keys.shape, -1, dtype=torch.int32, device=dev)
    _, info = fused_consume_plain(
        state, keys, values, todo, specs=(), checked=checked, grow_bound=grow_bound,
        threshold=threshold, bound_slack=bound_slack, collect_events=collect_events,
        tickets_out=tickets,
    )
    table.overflowed.logical_or_(table.count > table.max_groups)
    return tickets, info


MAX_BATCH_LANES = 32  # lanes one batched launch takes (csrc kMaxLanes)


def scan_ticket_batched(
    tables: Sequence[tk.TicketTable],
    keys,                  # N (npm, M) int32 tensors, EMPTY_I32-padded (an (N, npm, M) one)
    todo: torch.Tensor,    # (N, npm) int32 — 1: morsel still to commit
    *,
    thresholds: Sequence[int],
    bound_slacks: Sequence[int],
    checked: bool = True,
    states: Sequence[up.AggState] | None = None,
    values: Sequence[Mapping[str, torch.Tensor]] | None = None,
    specs: tuple | None = None,
):
    """:func:`scan_ticket` over N lanes at once (never under a GROW bound,
    which no batched plan has): lane ``i`` is ``keys[i]`` (each lane's own
    staged tensor; nothing is stacked) against ``tables[i]`` with
    ``todo[i]`` and the room check
    ``(thresholds[i], bound_slacks[i])``, each table and todo row updated in
    place exactly as a solo :func:`scan_ticket` call updates them (no event
    counts).

    Without ``states`` it returns ``(tickets, info)``: tickets ``(N, npm,
    M)`` and ONE ``(N, INFO_LEN)`` info tensor, so a single read resolves
    the round.  With ``states`` (each lane's :class:`~repro_torch.core.
    updates.AggState`, its ``(G,)`` float32 planes updated IN PLACE),
    ``values`` (each lane's staged ``{column: (npm, M) float32}`` planes)
    and ``specs`` (the lanes' common ``AggState.specs``; default the first
    lane's) it also folds, as ``update_agg_state`` with ``scatter_update``
    folds, every committed morsel's rows into its lane's planes, and
    returns ``(None, info)``: a morsel that pauses, or saturates under
    ``checked``, folds nothing and stays todo.

    CUDA tensors launch ``scan_ticket_batched_kernel`` of
    ``csrc/fused_groupby.cu`` (fold mode with ``states``), one launch per
    :data:`MAX_BATCH_LANES` lanes, each counted in
    ``scan_ticket_batched.launches`` (grid of the latest in
    ``scan_ticket_batched.grid``), and raise if they cannot, before any
    lane changes; each lane has :func:`scan_ticket`'s contract.  CPU
    tensors run :func:`scan_ticket_batched_plain`, lane by lane."""
    if todo.device.type == "cpu":
        return scan_ticket_batched_plain(tables, keys, todo, thresholds=thresholds,
                                         bound_slacks=bound_slacks, checked=checked,
                                         states=states, values=values, specs=specs)
    return launch_scan_ticket_batched(prepare_scan_ticket_batched(
        tables, keys, todo, thresholds=thresholds, bound_slacks=bound_slacks,
        checked=checked, states=states, values=values, specs=specs))


def _bad_tensor(t, dtype, dev) -> bool:
    return t.dtype != dtype or t.device != dev or not t.is_contiguous()


def prepare_scan_ticket_batched(tables, keys, todo, *, thresholds, bound_slacks,
                                checked=True, states=None, values=None, specs=None):
    """The host work of one :func:`scan_ticket_batched` call on CUDA
    tensors: the checks, the tickets (ticket mode), one allocation holding
    every lane's info row and launch scratch (filled on the card), and the
    lane descriptors as one array of 64-bit words.  What the signature
    makes equal across lanes (the specs, the round's shape, todo's dtype
    and device) is checked once; each lane's own tensors once each.
    :func:`launch_scan_ticket_batched` runs the launches on it; the two
    split the call to time them apart."""
    dev = todo.device
    if dev.type != "cuda":
        raise ValueError(f"scan_ticket_batched runs on cuda or cpu tensors, not {dev}")
    n = len(tables)
    if todo.dim() != 2 or n == 0 or todo.shape[0] != n or _bad_tensor(todo, torch.int32, dev):
        raise ValueError(f"todo {tuple(todo.shape)} is not a contiguous int32 (N, npm) on "
                         f"{dev} for N = {n} tables")
    npm = todo.shape[1]
    if len(keys) != n:
        raise ValueError(f"{len(keys)} key tensors for N = {n} tables")
    M = keys[0].shape[1] if keys[0].dim() == 2 else -1
    key_ptrs = []
    for k in keys:
        if tuple(k.shape) != (npm, M) or _bad_tensor(k, torch.int32, dev):
            raise ValueError(f"a lane's keys {tuple(k.shape)} are not contiguous int32 "
                             f"(npm, M) = ({npm}, {M}) on {dev}")
        key_ptrs.append(k.data_ptr())
    if len(thresholds) != n or len(bound_slacks) != n:
        raise ValueError(f"{len(thresholds)} thresholds / {len(bound_slacks)} slacks for "
                         f"N = {n} tables")
    for v in (*thresholds, *bound_slacks):
        if not -_INT32_MAX <= v <= _INT32_MAX:
            raise ValueError(f"room check {v} does not fit int32")
    fold = states is not None
    if fold:
        specs = tuple(states[0].specs if specs is None else specs)
        cols = sorted({c for c, _ in specs if c is not None})
        plane_of = [-1 if c is None or k == "count" else cols.index(c) for c, k in specs]
        kinds = [_KIND_CODE.get(k, -1) for _, k in specs]
        if not 1 <= len(specs) <= MAX_SPECS or -1 in kinds:
            raise ValueError(f"fold mode takes 1..{MAX_SPECS} specs of kinds "
                             f"{tuple(_KIND_CODE)}, got {specs}")
        if values is None or len(values) != n or len(states) != n:
            raise ValueError(f"{len(states)} states / {values and len(values)} value sets for "
                             f"N = {n} tables")
        if M > MAX_MORSEL_ROWS:
            raise ValueError(f"morsel of {M} rows exceeds fold mode's {MAX_MORSEL_ROWS}")
    words = []
    for i, t in enumerate(tables):
        for a in t[:4]:
            if _bad_tensor(a, torch.int32, dev):
                raise ValueError(f"a TicketTable of scan_ticket_batched holds {a.dtype} on "
                                 f"{a.device}, not contiguous int32 on {dev}")
        C, G = t.capacity, t.max_groups
        if (C & (C - 1) or t.tickets.numel() != C or t.count.numel() != 1
                or t.overflowed.numel() != 1 or t.overflowed.dtype != torch.bool
                or t.overflowed.device != dev):
            raise ValueError("inconsistent TicketTable shapes")
        words += (key_ptrs[i], 0, t.keys.data_ptr(), t.tickets.data_ptr(),
                  t.key_by_ticket.data_ptr(), t.count.data_ptr(), 0, 0, 0,
                  t.overflowed.data_ptr(), C, G, int(thresholds[i]), int(bound_slacks[i]))
        if fold:
            accs, vm = states[i].accs, values[i]
            if len(accs) != len(specs):
                raise ValueError(f"lane {i} holds {len(accs)} planes for {len(specs)} specs")
            for a in accs:
                if a.numel() != G or _bad_tensor(a, torch.float32, dev):
                    raise ValueError(f"lane {i}: an accumulator plane is not a contiguous "
                                     f"float32 ({G},) on {dev}")
                words.append(a.data_ptr())
            for c in cols:
                v = vm[c]
                if tuple(v.shape) != (npm, M) or _bad_tensor(v, torch.float32, dev):
                    raise ValueError(f"lane {i}: value plane {c!r} is not a contiguous "
                                     f"float32 ({npm}, {M}) on {dev}")
                words.append(v.data_ptr())
    aux = torch.empty((n * (INFO_LEN + _SCAN_SCRATCH),), dtype=torch.int32, device=dev)
    info = aux[: n * INFO_LEN].view(n, INFO_LEN)
    if npm == 0:  # no morsel: nothing to launch, nothing todo
        info[:, INFO_COUNT] = torch.stack([t.count.reshape(()) for t in tables])
        info[:, INFO_FIRST_HALT:] = torch.tensor([NO_HALT, 0, 0], dtype=torch.int32)
        return (None if fold else todo.new_empty((n, 0, M))), info, None, ()
    tickets = None if fold else torch.empty((n, npm, M), dtype=torch.int32, device=dev)
    # the per-lane pointers into the round's shared tensors
    width = len(words) // n
    base_info, base_scratch = aux.data_ptr(), aux.data_ptr() + 4 * n * INFO_LEN
    for i in range(n):
        w = i * width
        words[w + 1] = todo.data_ptr() + 4 * i * npm
        words[w + 6] = base_info + 4 * INFO_LEN * i
        words[w + 7] = base_scratch + 4 * _SCAN_SCRATCH * i
        if not fold:
            words[w + 8] = tickets.data_ptr() + 4 * i * npm * M
    words = array.array("q", words)
    planes = array.array("i", plane_of if fold else [0])
    kinds = array.array("i", kinds if fold else [0])
    args = (words.buffer_info()[0], n, len(specs) if fold else 0, len(cols) if fold else 0,
            planes.buffer_info()[0], kinds.buffer_info()[0], npm, M, int(checked))
    # the arrays and tensors behind the pointers stay referenced until the launch
    return tickets, info, args, (words, planes, kinds, aux, keys, todo, tables, states, values)


def launch_scan_ticket_batched(call):
    """Launch the kernel on :func:`prepare_scan_ticket_batched`'s call on
    the current stream, one launch per :data:`MAX_BATCH_LANES` lanes (each
    counted), and return :func:`scan_ticket_batched`'s ``(tickets,
    info)``.  Raises if the kernel cannot be built or launched; every
    lane is checked before the first launch."""
    tickets, info, args, _ = call
    if args is None:
        return tickets, info
    grid = (ctypes.c_int * 3)()
    lib = _kernel_library()
    err = lib.scan_ticket_batched_launch(*args, SCAN_BLOCK_THREADS, grid,
                                         torch.cuda.current_stream(info.device).cuda_stream)
    scan_ticket_batched.launches += grid[2]
    if err != 0:
        raise RuntimeError("scan_ticket_batched kernel launch failed: "
                           + lib.fused_groupby_error_string(err).decode())
    scan_ticket_batched.grid = (grid[0], grid[1])
    return tickets, info


scan_ticket_batched.launches = 0  # kernel launches (CUDA tensors only)
scan_ticket_batched.grid = None   # (CTAs, CTAs a lane) of the latest launch


def scan_ticket_batched_plain(tables, keys, todo, *, thresholds, bound_slacks,
                              checked=True, states=None, values=None, specs=None):
    """The plain version of :func:`scan_ticket_batched`, on any device, with
    its signature and in-place updates: one :func:`scan_ticket_plain` per
    lane, in lane order, and with ``states`` each lane's
    ``update_agg_state`` with ``scatter_update`` over its tickets right
    after (the scan operator's own update stage, so a folding round equals
    N solo chunks bit for bit).  Each lane's planes follow its own
    ``AggState.specs``, which the batch signature makes the round's
    ``specs``."""
    outs = []
    for i, t in enumerate(tables):
        tickets, info = scan_ticket_plain(t, keys[i], todo[i], checked=checked,
                                          threshold=int(thresholds[i]),
                                          bound_slack=int(bound_slacks[i]))
        if states is not None:
            up.update_agg_state(states[i], tickets.reshape(-1),
                                {c: v.reshape(-1) for c, v in values[i].items()},
                                up.scatter_update)
        outs.append((tickets, info))
    info = torch.cat([o[1] for o in outs]) if outs else todo.new_empty((0, INFO_LEN))
    if states is not None:
        return None, info
    tickets = torch.stack([o[0] for o in outs]) if outs else todo.new_empty((0, 0, 0))
    return tickets, info


def fused_groupby(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int,
    max_groups: int,
    kind: str = "sum",
    morsel_size: int = 1024,
):
    """One fused pass over raw arrays → ``(key_by_ticket, acc, count)``:
    fresh state, one program, unchecked (the counterpart of
    ``repro.kernels.fused_groupby.fused_groupby_pallas``).  Keys come back
    as int64 holding the unsigned value; untouched min/max slots are NaN."""
    n = keys.shape[0]
    if n % morsel_size:
        raise ValueError(f"{n} rows are not a multiple of morsel_size={morsel_size}")
    num = n // morsel_size
    k2 = to_i32_bits(keys).reshape(num, morsel_size).contiguous()
    v2 = values.to(torch.float32).reshape(1, num, morsel_size).contiguous()
    state = init_fused_state(capacity=capacity, max_groups=max_groups,
                             kinds=(kind,), device=keys.device)
    specs = ((-1 if kind == "count" else 0, kind),)
    state, _ = fused_consume(
        state, k2, v2, torch.ones((num,), dtype=torch.int32, device=keys.device),
        specs=specs, checked=False, grow_bound=False, collect_events=False,
    )
    acc = state.accs[0, 0]
    if kind in ("min", "max"):
        acc = torch.where(torch.isinf(acc), torch.full_like(acc, float("nan")), acc)
    return state.kbt[0].to(torch.int64) & 0xFFFFFFFF, acc, state.count[0]


fused_groupby_pallas = fused_groupby  # the reference's name


def from_jax_state(arrays: Sequence[np.ndarray], device=None) -> FusedState:
    """A JAX ``FusedState`` given as numpy arrays (field order tkeys, ttks,
    kbt, accs, count, events) → the port's :class:`FusedState`."""
    dtypes = (np.int32, np.int32, np.int32, np.float32, np.int32, np.int32)
    out = []
    for a, dt in zip(arrays, dtypes, strict=True):
        a = np.asarray(a)
        a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(dt, copy=False)
        out.append(torch.from_numpy(np.array(a, order="C", copy=True)).to(device))
    return FusedState(*out)


def to_numpy(state: FusedState) -> tuple:
    """The port's state as numpy arrays in JAX ``FusedState`` field order
    and dtypes (the inverse of :func:`from_jax_state`)."""
    return tuple(t.detach().cpu().numpy() for t in state)


def scan_ticket_discrepancies(keys: torch.Tensor, out, ref, *, full: bool = False) -> int:
    """How far a :func:`scan_ticket` launch (``out``: its tickets and the
    table it updated) breaks the contract with :func:`scan_ticket_plain`
    on the same keys from the same table (``ref``); 0 when it keeps it.
    Both launches must commit every morsel.  The rules are the ticket
    kernel's (``ticket_hash.ticket_map_discrepancies``): the same count,
    gap-free tickets consistent with the table and ``key_by_ticket``, and
    the same key set and -1 rows (when ``full``: a row is -1 iff its key is
    not in the table)."""
    from repro_torch.kernels.ticket_hash import ticket_map_discrepancies

    def flat(o):
        tickets, t = o
        return (tickets.reshape(-1), t.keys, t.tickets, t.key_by_ticket, t.count)

    return ticket_map_discrepancies(keys.reshape(-1), flat(out), flat(ref), full=full)
