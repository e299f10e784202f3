"""Elastic streams: a checkpointable ``StreamHandle``.

Port of ``repro.engine.elastic`` for every single-device executor.

1. **Checkpointable streams.**  ``StreamHandle.save(path)`` serializes the
   full executor state — the ``TicketTable`` / ``AggState`` of the scan
   route's operator, the carried :class:`~repro_torch.core.adaptive.RunningStats`
   sketch of an ``auto`` plan, the spill partitions, the merge table of the
   split and partitioned routes, plus the ingest chunk cursor — through
   ``checkpoint/manager.py``'s atomic-commit contract (temp dir + rename, so
   a crash mid-save never corrupts the last commit).
   ``GroupByPlan.restore(path, source)`` rebuilds the executor from the
   newest commit, fast-forwards the (replayed-from-the-start) source past
   the chunks the checkpoint already aggregated, and returns a live handle
   that resumes where the saved one stood.

2. **Server recovery** lives in ``serve/query_server.py``: a quantum that
   raises ``WorkerFailure`` restores its stream from the last checkpoint
   while other tenants keep stepping.

The commit format is the reference's, key for key: a commit written by
either package restores in the other, on the CPU or on a card.  The port
holds key columns as int32 bit patterns; they are stored as the
reference's uint32 values (``keys``, ``kbt``, hybrid ``heavy``, sort
``keys``, spill ``__key__``), and the hybrid route's ``(S, R)`` register
tensor as the reference's one ``reg/{i}`` array per accumulator.  Every
array is copied to the host before it is written, and copied into
contiguous tensors on the restoring plan's device when it is read: the
port updates tables and accumulators in place.

A restored default plan (``strategy="auto"``) takes the route its
resolution would take on the restoring plan's device: the commit records
the resolved ``update``, ``ticketing`` and ``key_domain``, and
``executors.cuda_route`` applies on a card as it does at resolution.

Restore contract: ``restore(path, source)`` replays ``source`` from its
beginning and SKIPS the chunks the checkpoint already consumed, so the
source must be re-iterable with a stable chunk order (a ``Table``, an
``ArraySource`` / ``BlockSource``, any ``chunks()`` object that restarts —
NOT a half-drained bare iterator).

Multi-device sharding (ROADMAP.md item 9) brings the sharded executor's
carry, the survivor mesh and the in-place re-mesh; until then
:func:`stream_mesh` is ``None`` for every stream and :func:`remesh_stream`
raises the reference's ``TypeError``.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import adaptive
from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.engine.executors import (
    _DirectExecutor,
    _HybridExecutor,
    _IncrementalMergeExecutor,
    _ResolvingExecutor,
    _ScanExecutor,
    _SortExecutor,
    cuda_route,
    make_executor,
)
from repro_torch.engine.groupby import expand_agg_specs
from repro_torch.engine.plan_api import GroupByPlan, StreamHandle, iter_chunks
from repro_torch.engine.spill import SpillExecutor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

FORMAT = "repro.elastic/v1"


# ---------------------------------------------------------------------------
# flat-dict plumbing


_get = ckpt.host_copy


def _get_keys(t: torch.Tensor) -> np.ndarray:
    """int32 key bit patterns → the reference's uint32 values."""
    return _get(t).view(np.uint32)


def _put(a, device, dtype) -> torch.Tensor:
    """A stored array → a fresh contiguous tensor of ``dtype`` on
    ``device`` (uint32 keys keep their bits as int32)."""
    a = np.asarray(a)
    if a.dtype == np.uint32 and dtype == torch.int32:
        a = a.view(np.int32)
    if not a.flags.c_contiguous:
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype, copy=True)


def _nest(arrays: dict, prefix: str, sub: dict) -> None:
    for k, v in sub.items():
        arrays[f"{prefix}/{k}"] = v


def _sub(arrays: dict, prefix: str) -> dict:
    p = prefix + "/"
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


def _plan_fingerprint(plan: GroupByPlan) -> dict:
    """What must match between the saving and the restoring plan: the query
    semantics.  Strategy knobs (device, prefetch) may differ."""
    return {
        "keys": list(plan.keys),
        "aggs": [[a.kind, a.column] for a in plan.aggs],
        "raw_keys": bool(plan.raw_keys),
    }


# ---------------------------------------------------------------------------
# per-piece serializers


def _export_table(table: tk.TicketTable) -> dict:
    return {
        "keys": _get_keys(table.keys),
        "tickets": _get(table.tickets),
        "kbt": _get_keys(table.key_by_ticket),
        "count": _get(table.count),
        "ovf": _get(table.overflowed),
    }


def _import_table(sub: dict, device) -> tk.TicketTable:
    return tk.TicketTable(
        _put(sub["keys"], device, torch.int32), _put(sub["tickets"], device, torch.int32),
        _put(sub["kbt"], device, torch.int32),
        _put(sub["count"], device, torch.int32).reshape(()),
        _put(sub["ovf"], device, torch.bool).reshape(()),
    )


def _export_op(op) -> tuple[dict, dict]:
    """Serialize a live :class:`GroupByOperator`: probe table, accumulator
    state, the (possibly grown) bound, and the host counters."""
    arrays: dict = {}
    _nest(arrays, "table", _export_table(op._table))
    for i, acc in enumerate(op._state.accs):
        arrays[f"acc/{i}"] = _get(acc)
    if op._events is not None:
        arrays["events"] = _get(op._events)
    meta = {
        "max_groups": int(op.max_groups),
        "overflowed": bool(op._overflowed),
        "migrations": int(op.migrations),
        "bound_grows": int(op.bound_grows),
    }
    return arrays, meta


def _import_op(op, arrays: dict, meta: dict) -> None:
    dev = op._device
    specs = op._state.specs
    op.load_state(_import_table(_sub(arrays, "table"), dev), up.AggState(specs, tuple(
        _put(arrays[f"acc/{i}"], dev, torch.float32) for i in range(len(specs))
    )))
    op.max_groups = int(meta["max_groups"])
    op._overflowed = bool(meta["overflowed"])
    op.migrations = int(meta["migrations"])
    op.bound_grows = int(meta["bound_grows"])
    if "events" in arrays and op._events is not None:
        op._events = _put(arrays["events"], dev, torch.int32)


def _export_sketch(s: adaptive.RunningStats) -> tuple[dict, dict]:
    items = sorted(s._counters.items())
    arrays = {
        "counter_keys": np.asarray([k for k, _ in items], np.uint32),
        "counter_vals": np.asarray([v for _, v in items], np.int64),
        "distinct": np.asarray(sorted(s._distinct), np.uint32),
    }
    meta = {
        "n_rows": int(s.n_rows),
        "sampled": int(s.sampled),
        "saturated": bool(s._distinct_saturated),
        "domain": s.domain,
    }
    return arrays, meta


def _import_sketch(s: adaptive.RunningStats, arrays: dict, meta: dict) -> None:
    s.n_rows = int(meta["n_rows"])
    s.sampled = int(meta["sampled"])
    s._distinct_saturated = bool(meta["saturated"])
    s.domain = meta.get("domain")
    s._counters = dict(zip(
        arrays["counter_keys"].tolist(), arrays["counter_vals"].tolist()
    ))
    s._distinct = set(arrays["distinct"].tolist())


# ---------------------------------------------------------------------------
# per-executor serializers (dispatch on concrete class)


def _executor_label(ex) -> str:
    if isinstance(ex, _ResolvingExecutor):
        return "resolving"
    return ex.strategy_label


def export_executor(ex) -> tuple[dict, dict]:
    """``(flat numpy arrays, json-able meta)`` capturing the executor's full
    carried state, as host copies.  The inverse is :func:`import_executor`
    on a freshly ``open()``-ed executor of an equivalent plan.  The fused
    route's executor raises ``TypeError``, as in the reference."""
    arrays: dict = {}
    meta: dict = {"executor": _executor_label(ex)}

    if isinstance(ex, _ResolvingExecutor):
        sk_arrays, sk_meta = _export_sketch(ex._stats)
        _nest(arrays, "sketch", sk_arrays)
        meta["sketch"] = sk_meta
        meta["escalated"] = bool(ex._escalated)
        if ex._inner is None:
            meta["resolved"] = None
            return arrays, meta
        r = ex._resolved
        meta["resolved"] = {
            "strategy": "hybrid" if ex._escalated else r.strategy,
            "max_groups": r.max_groups,
            "saturation": r.saturation,
            "update": r.execution.update,
            "ticketing": r.execution.ticketing,
            "key_domain": r.execution.key_domain,
        }
        in_arrays, in_meta = export_executor(ex._inner)
        _nest(arrays, "inner", in_arrays)
        meta["inner"] = in_meta
        return arrays, meta

    if isinstance(ex, _ScanExecutor):
        op_arrays, op_meta = _export_op(ex._op)
        _nest(arrays, "op", op_arrays)
        meta["op"] = op_meta
        return arrays, meta

    if isinstance(ex, _DirectExecutor):
        started = ex._state is not None
        meta.update(
            started=started, domain=int(ex._domain), bound=int(ex._bound),
            rows=int(ex._rows), dropped=bool(ex._dropped),
            max_ticket=int(ex._max_ticket),
        )
        if started:
            for i, acc in enumerate(ex._state.accs):
                arrays[f"acc/{i}"] = _get(acc)
        return arrays, meta

    if isinstance(ex, _HybridExecutor):
        started = ex._op is not None
        meta["started"] = started
        if started:
            arrays["heavy"] = _get_keys(ex._heavy)
            for i in range(len(ex._kinds)):
                arrays[f"reg/{i}"] = _get(ex._regs[i])
            op_arrays, op_meta = _export_op(ex._op)
            _nest(arrays, "op", op_arrays)
            meta["op"] = op_meta
        return arrays, meta

    if isinstance(ex, _SortExecutor):
        if ex._keys:
            keys, vals = ex._gathered()
            arrays["keys"] = _get_keys(keys)
        else:
            vals = {}
            arrays["keys"] = np.zeros((0,), np.uint32)
        for c, v in vals.items():
            arrays[f"val/{c}"] = _get(v)
        meta.update(rows=int(ex._rows), vcols=sorted(vals))
        return arrays, meta

    if isinstance(ex, SpillExecutor):
        ex._flush_staged()  # staged cold batches belong to the manager
        op_arrays, op_meta = _export_op(ex._op)
        _nest(arrays, "op", op_arrays)
        meta["op"] = op_meta
        sk_arrays, sk_meta = _export_sketch(ex._sketch)
        _nest(arrays, "sketch", sk_arrays)
        meta["sketch"] = sk_meta
        arrays["resident"] = np.array(ex._resident, copy=True)
        m = ex._manager
        blocks_per_partition = []
        for pid, blocks in enumerate(m._blocks):
            blocks_per_partition.append(len(blocks))
            for bi, block in enumerate(blocks):
                for col, t in block.items():
                    arrays[f"mgr/p{pid}/b{bi}/{col}"] = (
                        _get_keys(t) if col == "__key__" else _get(t))
        meta["manager"] = {
            "blocks_per_partition": blocks_per_partition,
            "partition_rows": list(m.partition_rows),
            "partition_bytes": list(m.partition_bytes),
            "spilled_rows": int(m.spilled_rows),
            "spilled_bytes": int(m.spilled_bytes),
            "spill_events": int(m.spill_events),
            "readmitted_rows": int(m.readmitted_rows),
        }
        meta.update(
            host_count=int(ex._host_count), rows=int(ex._rows),
            readmission_passes=int(ex._readmission_passes),
            peak_device_bytes=int(ex._peak_device_bytes),
        )
        return arrays, meta

    if isinstance(ex, _IncrementalMergeExecutor):
        if ex._pending is not None:
            # lower the held first-chunk partial into the carried table so
            # the serialized state is the one canonical form (the native
            # single-chunk layout is a materialization fast path, not state)
            pending, ex._pending = ex._pending, None
            ex._merge(pending)
        _nest(arrays, "table", _export_table(ex._table))
        for i, spec in enumerate(ex._specs):
            arrays[f"acc/{i}"] = _get(ex._accs[spec])
        meta.update(
            max_groups=int(ex._max_groups), chunk_bound=int(ex._chunk_bound),
            rows=int(ex._rows), host_count=int(ex._host_count),
            merged_any=bool(ex._merged_any), ovf=bool(ex._ovf),
        )
        return arrays, meta

    raise TypeError(
        f"executor {type(ex).__name__} does not support checkpointing"
    )


def import_executor(ex, arrays: dict, meta: dict) -> None:
    """Restore :func:`export_executor` state into a freshly built executor
    of a plan with the same query semantics, on the plan's device."""
    label = meta.get("executor")

    if isinstance(ex, _ResolvingExecutor):
        if label != "resolving":
            raise ValueError(
                f"checkpoint was saved by a {label!r} executor; restore with "
                "the equivalent resolved plan or the original auto plan"
            )
        _import_sketch(ex._stats, _sub(arrays, "sketch"), meta["sketch"])
        ex._escalated = bool(meta["escalated"])
        if meta["resolved"] is None:
            return
        r = meta["resolved"]
        resolved = replace(
            ex._plan, strategy=r["strategy"], max_groups=r["max_groups"],
            saturation=r["saturation"],
            execution=replace(
                ex._plan.execution, update=r["update"],
                ticketing=r["ticketing"], key_domain=r["key_domain"],
            ),
        )
        # the route resolution takes on this plan's device (the commit
        # records no kernel): scan_body + scatter on a card
        ex._resolved = cuda_route(ex._plan, resolved)
        ex._inner = make_executor(ex._resolved)
        ex._inner.open()
        import_executor(ex._inner, _sub(arrays, "inner"), meta["inner"])
        return

    if label != _executor_label(ex):
        raise ValueError(
            f"checkpoint was saved by a {label!r} executor but the restoring "
            f"plan lowers to {_executor_label(ex)!r}; keep the strategy/"
            "saturation/ticketing fields equivalent across save and restore"
        )
    if isinstance(ex, _ScanExecutor):
        _import_op(ex._op, _sub(arrays, "op"), meta["op"])
        return

    dev = ex._device

    if isinstance(ex, _DirectExecutor):
        ex._domain = int(meta["domain"])
        ex._bound = int(meta["bound"])
        ex._rows = int(meta["rows"])
        ex._dropped = torch.tensor(bool(meta["dropped"]), device=dev)
        ex._max_ticket = torch.tensor(int(meta["max_ticket"]), dtype=torch.int32, device=dev)
        if meta["started"]:
            specs = expand_agg_specs(ex._plan.aggs)
            ex._state = up.AggState(specs, tuple(
                _put(arrays[f"acc/{i}"], dev, torch.float32) for i in range(len(specs))
            ))
        return

    if isinstance(ex, _HybridExecutor):
        if not meta["started"]:
            return
        ex._heavy = _put(arrays["heavy"], dev, torch.int32)
        ex._op = ex._make_op(meta["op"]["max_groups"])
        _import_op(ex._op, _sub(arrays, "op"), meta["op"])
        ex._regs = torch.stack([
            _put(arrays[f"reg/{i}"], dev, torch.float32) for i in range(len(ex._kinds))
        ])
        return

    if isinstance(ex, _SortExecutor):
        ex._rows = int(meta["rows"])
        if arrays["keys"].shape[0]:
            ex._keys = [_put(arrays["keys"], dev, torch.int32)]
            ex._vals = [{
                c: _put(arrays[f"val/{c}"], dev, torch.float32) for c in meta["vcols"]
            }]
            ex.peak_buffered_chunks = 1
            ex.peak_retained_bytes = int(arrays["keys"].nbytes) + sum(
                int(arrays[f"val/{c}"].nbytes) for c in meta["vcols"]
            )
        return

    if isinstance(ex, SpillExecutor):
        _import_op(ex._op, _sub(arrays, "op"), meta["op"])
        _import_sketch(ex._sketch, _sub(arrays, "sketch"), meta["sketch"])
        ex._resident = np.asarray(arrays["resident"]).astype(bool).copy()
        ex._host_count = int(meta["host_count"])
        ex._rows = int(meta["rows"])
        ex._readmission_passes = int(meta["readmission_passes"])
        ex._peak_device_bytes = int(meta["peak_device_bytes"])
        mm = meta["manager"]
        m = ex._manager
        m.partition_rows = list(mm["partition_rows"])
        m.partition_bytes = list(mm["partition_bytes"])
        m.spilled_rows = int(mm["spilled_rows"])
        m.spilled_bytes = int(mm["spilled_bytes"])
        m.spill_events = int(mm["spill_events"])
        m.readmitted_rows = int(mm["readmitted_rows"])
        # host partitions: CPU tensors, keys as int32 bit patterns
        cols = {"__key__": torch.int32, **{c: torch.float32 for c in m._value_cols}}
        m._blocks = [
            [
                {col: _put(arrays[f"mgr/p{pid}/b{bi}/{col}"], "cpu", dtype)
                 for col, dtype in cols.items()}
                for bi in range(nblocks)
            ]
            for pid, nblocks in enumerate(mm["blocks_per_partition"])
        ]
        return

    if isinstance(ex, _IncrementalMergeExecutor):
        ex._max_groups = int(meta["max_groups"])
        ex._chunk_bound = int(meta["chunk_bound"])
        ex._rows = int(meta["rows"])
        ex._host_count = int(meta["host_count"])
        ex._merged_any = bool(meta["merged_any"])
        ex._ovf = torch.tensor(bool(meta["ovf"]), device=dev)
        ex._table = _import_table(_sub(arrays, "table"), dev)
        ex._accs = {
            spec: _put(arrays[f"acc/{i}"], dev, torch.float32)
            for i, spec in enumerate(ex._specs)
        }
        return

    raise TypeError(
        f"executor {type(ex).__name__} does not support checkpointing"
    )


# ---------------------------------------------------------------------------
# stream save / restore


def save_stream(handle: StreamHandle, path: str, *,
                step: int | None = None) -> str:
    """Checkpoint a live stream: drain the in-flight ingest window (state
    must be settled — the pause-commits-nothing invariant makes the chunk
    boundary a consistent cut), serialize the executor to host copies, and
    atomically commit under ``path``.  Returns the committed directory."""
    if handle.cancelled:
        raise ValueError("cannot checkpoint a cancelled stream")
    if handle.closed:
        raise ValueError("stream already finalized via result()")
    with obs_trace.span("stream_save", chunks=handle.chunks_consumed):
        handle._drain_inflight()
        ex = handle.executor
        arrays, meta = export_executor(ex)
        meta["format"] = FORMAT
        meta["plan"] = _plan_fingerprint(ex._plan)
        meta["ingest"] = {
            "chunks_consumed": handle.chunks_consumed,
            "rows_consumed": handle.rows_consumed,
        }
        if step is None:
            step = handle.chunks_consumed
        out = ckpt.commit_payload(path, step, {"stream": arrays}, meta)
    if obs_metrics.enabled():
        obs_metrics.counter("elastic.saves").add(1)
    return out


def fast_forward(chunks, skip: int) -> None:
    """Pull and drop the first ``skip`` chunks of a replayed source (the
    chunks a checkpoint already aggregated)."""
    for i in range(skip):
        if next(chunks, None) is None:
            raise ValueError(
                f"source exhausted after {i} chunks but the checkpoint "
                f"cursor is at {skip} — restore() replays the SAME "
                "source from its beginning (re-iterable, stable order)"
            )


def restore_stream(plan: GroupByPlan, path: str, source, *,
                   prefetch: int | None = None) -> StreamHandle:
    """Rebuild a stream from the newest commit under ``path`` and resume it
    over ``source`` (replayed from its beginning; the chunks the checkpoint
    already aggregated are skipped without being consumed).  The restoring
    plan must ask the same query; its device may differ."""
    rec = ckpt.latest_commit(path, names=("stream",))
    if rec is None:
        raise FileNotFoundError(f"no committed checkpoint under {path!r}")
    step, payload, meta = rec
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a stream checkpoint: {path!r}")
    if meta["plan"] != _plan_fingerprint(plan):
        raise ValueError(
            f"checkpoint {path!r} was saved by a different query "
            f"({meta['plan']}) than the restoring plan "
            f"({_plan_fingerprint(plan)})"
        )
    with obs_trace.span("stream_restore", step=step):
        ex = make_executor(plan)
        ex.open()
        import_executor(ex, payload["stream"], meta)
        chunks = iter_chunks(source)
        skip = int(meta["ingest"]["chunks_consumed"])
        fast_forward(chunks, skip)
        pf = plan.execution.prefetch if prefetch is None else prefetch
        handle = StreamHandle(ex, chunks, prefetch=pf)
        handle.chunks_consumed = skip
        handle.rows_consumed = int(meta["ingest"]["rows_consumed"])
    if obs_metrics.enabled():
        obs_metrics.counter("elastic.restores").add(1)
    return handle


# ---------------------------------------------------------------------------
# mid-stream re-mesh (sharded streams: ROADMAP.md item 9)


def _unwrap(ex):
    inner = getattr(ex, "_inner", None)
    return inner if inner is not None else ex


def stream_mesh(handle: StreamHandle):
    """The device mesh a live stream's executor runs on, ``None`` for the
    single-device strategies (the server's cheap per-quantum loss probe:
    only a meshed stream can re-mesh in place).  No port executor has a
    mesh yet."""
    if handle.executor is None:
        return None
    ex = _unwrap(handle.executor)
    return ex._plan.execution.mesh if hasattr(ex, "remesh") else None


def remesh_stream(handle: StreamHandle, mesh=None, *,
                  axis: str | None = None) -> bool:
    """Re-mesh a live sharded stream at a chunk boundary onto ``mesh``
    (drains the in-flight window first).  A stream that is not sharded
    raises ``TypeError``: it recovers by checkpoint restore."""
    if handle.cancelled or handle.closed:
        raise ValueError("cannot re-mesh a cancelled/finalized stream")
    ex = _unwrap(handle.executor)
    if not hasattr(ex, "remesh"):
        raise TypeError(
            "mid-stream re-mesh needs strategy='sharded' (other strategies "
            "recover by checkpoint restore: save() → restore())"
        )
    if mesh is None:
        raise NotImplementedError(
            "the survivor mesh of a sharded stream is not ported yet: ROADMAP "
            "'Modules to port' item 9 (multi-device sharding)"
        )
    handle._drain_inflight()
    ex.remesh(mesh, axis=axis or ex._plan.execution.axis)
    return True


__all__ = [
    "export_executor",
    "import_executor",
    "remesh_stream",
    "restore_stream",
    "save_stream",
    "stream_mesh",
]
