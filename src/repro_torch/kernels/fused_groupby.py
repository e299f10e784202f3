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
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import EMPTY_I32, table_capacity, to_i32_bits
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


def _check_launch(state: FusedState, keys, values, todo, specs) -> None:
    """Device, dtype, shape and contiguity checks shared by both paths."""
    dev = keys.device
    for name, t, dtype in (
        ("keys", keys, torch.int32), ("values", values, torch.float32),
        ("todo", todo, torch.int32), ("tkeys", state.tkeys, torch.int32),
        ("ttks", state.ttks, torch.int32), ("kbt", state.kbt, torch.int32),
        ("accs", state.accs, torch.float32), ("count", state.count, torch.int32),
        ("events", state.events, torch.int32),
    ):
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
    if len(specs) != S or not 1 <= S <= MAX_SPECS:
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
):
    """The plain PyTorch version of the fused kernel: the Pallas kernel's
    protocol step for step (``core.ticketing.get_or_insert`` claim rounds
    per morsel), on any device, updating ``state`` and ``todo`` in place.
    Each program runs its todo morsels in order; at its first pause (or
    saturation under ``checked``) it leaves that morsel and every later
    one todo — the kernel's rule with one CTA.  With
    ``todo_from_start(P, npm, start)`` it matches JAX
    ``fused_consume(..., start, interpret=True)`` ticket for ticket."""
    _check_launch(state, keys, values, todo, specs)
    dev = keys.device
    P = state.programs
    S, _, G = state.accs.shape
    _, total, M = values.shape
    npm = total // P
    info = torch.zeros((P, INFO_LEN), dtype=torch.int32, device=dev)
    edges = torch.tensor(obs_metrics.PROBE_HIST_EDGES, dtype=torch.int32, device=dev)
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    ones = torch.ones((M,), dtype=torch.float32, device=dev)
    flags = todo.reshape(P, npm).tolist()
    for p in range(P):
        count = int(state.count[p])
        sat_any, halted = 0, 0
        ev = [0] * obs_metrics.EVENT_VEC_LEN
        hist = torch.zeros(obs_metrics.PROBE_HIST_BUCKETS, dtype=torch.int64, device=dev)
        for i in (i for i in range(npm) if flags[p][i]):
            if checked and (count > threshold or (grow_bound and count > bound_slack)):
                halted = 1
                ev[obs_metrics.EVT_PAUSES] += 1
                break
            row = p * npm + i
            mk = keys[row]
            table = tk.TicketTable(
                state.tkeys[p], state.ttks[p], state.kbt[p],
                torch.tensor(count, dtype=torch.int32, device=dev), no_ovf,
            )
            tickets, table, plen = tk.get_or_insert(table, mk, count_probes=True)
            state.tkeys[p].copy_(table.keys)
            state.ttks[p].copy_(table.tickets)
            state.kbt[p].copy_(table.key_by_ticket)
            count = int(table.count)
            valid = mk != EMPTY_I32
            sat = bool(((tickets < 0) & valid).any())
            if sat:
                sat_any = 1
                ev[obs_metrics.EVT_PROBE_SATURATIONS] += 1
            if checked and sat:
                halted = 1
                ev[obs_metrics.EVT_PAUSES] += 1
                break
            do = valid & (tickets >= 0) & (tickets < G)
            t = tickets[do].to(torch.int64)
            for s, (plane, kind) in enumerate(specs):
                v = (ones if plane < 0 else values[plane, row])[do]
                acc = state.accs[s, p]
                if kind in ("sum", "count"):
                    acc.index_add_(0, t, v)
                else:
                    acc.scatter_reduce_(0, t, v, "amin" if kind == "min" else "amax")
            flags[p][i] = 0
            todo[row] = 0
            n_valid = int(valid.sum())
            ev[obs_metrics.EVT_MORSELS] += 1
            ev[obs_metrics.EVT_ROWS] += n_valid
            ev[obs_metrics.EVT_ROWS_MASKED] += M - n_valid
            ev[obs_metrics.EVT_PROBE_STEPS] += int(plen.sum())
            bucket = torch.searchsorted(edges, plen[valid], right=True)
            hist += torch.bincount(bucket, minlength=obs_metrics.PROBE_HIST_BUCKETS)
        if collect_events:
            add = torch.tensor(ev, dtype=torch.int32, device=dev)
            add[obs_metrics.NUM_EVENTS:] += hist.to(torch.int32)
            state.events[p] += add
        state.count[p] = count
        lowest = next((i for i in range(npm) if flags[p][i]), NO_HALT)
        info[p] = torch.tensor([count, lowest, sat_any, halted], dtype=torch.int32)
    return state, info


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
