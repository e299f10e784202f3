"""Multi-pod dry run of the port: trace every (arch × shape × mesh) cell's
step on ``meta`` tensors (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for the 16×16 and 2×16×16
production meshes and reads XLA's memory and cost analyses.  The port has
no compiler to ask: it runs the cell's step, built from its own code
(``train/loop.py``, ``models/transformer.py``), on ``meta`` tensors, which
carry shapes and dtypes and no storage, under :class:`CostMode`, a
``TorchDispatchMode`` that counts what one member of the production mesh
holds and does:

* FLOPs: the matmul family by ``torch.utils.flop_counter``'s formulas,
  one a reduced element of a reduction, and one an output element of a
  pointwise op, as XLA counts them; ``transcendentals`` one an output
  element of exp, log, tanh, sigmoid, sqrt, rsqrt, sin, cos, pow, erf and
  the ops built on them (silu, gelu, softmax, logsumexp).
* ``bytes accessed``: each op's inputs plus its outputs.  Eager ops are
  not fused, so expect more than XLA's figure for the same step.
* Kernels written by hand (B3, B6, B5, the ticket and segment kernels)
  by the formulas of their bounds (``launch/roofline.py`` ``counted``).
* Live bytes by storage, freed through weakref finalizers: a
  liveness-aware peak (``peak_exact`` True).
* Collectives: the record of ``parallel/sharding.py``'s (result bytes).

**What a member's figure holds.**  The port's placed training step
(``train/loop.py`` ``jit_train_step``) does not partition its compute over
``model``: a data member gathers the whole parameters, runs forward and
backward on ``global_batch / dp`` rows, then one float32 gradient sum over
the data members, one clip and its slice of the AdamW update.  Running the
step over 256 meta members would measure the whole mesh on one device, so
the dry run traces ONE data member's share: ``jit_train_step`` on a (data
1, model M) mesh of meta members (pod 1 on the multi-pod mesh) at that
member's rows.  The other ``model`` members' parts of the parameters and
moments exist in that trace but are not the member's: their storages are
marked, left out of the live bytes, and the ops on them (their slices of
the update) are not counted.  The gradient sum over the data members,
which a trace of one data member cannot see, is added as one all-reduce
of the float32 gradient.  Argument bytes are what the member holds by
``NamedSharding.shard_shape`` of the production mesh's specs.  Prefill and
decode cells trace ``decode_step`` on one data member's rows after it
gathers the whole parameters and its rows' caches from their parts (the
structure of ``serve/engine.py`` ``jit_serve_step``; no write-back).

MoE cells run expert parallelism (``moe_impl="ep"`` with :func:`_ep_info`),
where the port runs a ``model`` group's members together around
``all_to_all``: the dry run traces one group, (data 1, model M), on one
data coordinate's rows with whole parameters, and reports the group's
figures over its size M (peak included: the group's live bytes over M).

:func:`extrapolated_cost` (total(L) = fixed + L·body from 1- and 2-layer
siblings) is what ``run_cell(with_cost=True)``, the CLI's default, reports
as ``cost``; ``cost_raw_scanned`` is the full trace's count, which in the
port already holds every layer (no scan is counted once).  Tests and
``chip_smoke.py`` call ``run_cell(with_cost=False)`` to keep the trace to
one step.  The roofline's constants are an H100 SXM's
(``launch/roofline.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.launch import roofline
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (
    collective_bytes,
    derive_terms,
    model_flops_estimate,
)
from repro_torch.models import transformer as tf
from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell
from repro_torch.parallel import sharding
from repro_torch.train import loop

META = torch.device("meta")

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid", "sqrt",
    "rsqrt", "sin", "cos", "pow", "erf", "silu", "silu_backward", "gelu", "gelu_backward",
    "softplus", "_softmax", "_log_softmax", "logsumexp", "logit",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std", "var_mean",
    "linalg_vector_norm", "norm", "logsumexp", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "cumsum",
}
_ALLOCATIONS = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
                "empty_permuted"}


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):  # no storage (sparse, wrapper)
        return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes accessed, transcendentals, live and peak bytes
    and collectives of what runs inside it (see the module docstring), on
    any device: ``meta`` for a dry run, CPU or CUDA tensors for the same
    step run for real.  Storages marked :meth:`other` (another member's
    parts) hold no live bytes, and an op that reads one, or writes one in
    place, is not counted; its fresh outputs are marked in turn."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.record: list = []
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}
        self._others: set = set()
        self._paused = 0

    def __enter__(self):
        roofline.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        roofline.ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- storages ---------------------------------------------------------

    def hold(self, t: torch.Tensor, nbytes: int | None = None) -> None:
        """Count ``t``'s storage as live until it is freed."""
        key = _storage_key(t)
        if key is None or key in self._sizes or key in self._others:
            return
        st = t.untyped_storage()
        size = st.nbytes() if nbytes is None else nbytes
        self._sizes[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def other(self, t: torch.Tensor) -> None:
        """Mark ``t``'s storage as another member's."""
        key = _storage_key(t)
        if key is None or key in self._others:
            return
        if key in self._sizes:
            self.live -= self._sizes.pop(key)
        self._others.add(key)
        weakref.finalize(t.untyped_storage(), self._others.discard, key)

    def is_other(self, t) -> bool:
        return isinstance(t, torch.Tensor) and _storage_key(t) in self._others

    def _free(self, key) -> None:
        size = self._sizes.pop(key, None)
        if size is not None:
            self.live -= size

    # -- the hooks of launch/roofline.py ----------------------------------

    def collective(self, kind: str, nbytes: int) -> None:
        if not self._paused:
            self.record.append((kind, nbytes))

    def kernel(self, fn: Callable, work: Callable, args, kwargs):
        if self._paused:
            return fn(*args, **kwargs)
        flops, nbytes = work(*args, **kwargs)
        self._paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._paused -= 1
        self.flops += flops
        self.bytes += nbytes
        sizes: dict = {}  # a kernel's outputs by storage: the bytes its views hold
        firsts = {}
        for t in _tensors(out):
            key = _storage_key(t)
            sizes[key] = sizes.get(key, 0) + _nbytes(t)
            firsts.setdefault(key, t)
        for key, t in firsts.items():
            self.hold(t, sizes[key])
        return out

    # -- ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if name.startswith("_foreach_"):
            self._count_foreach(name, args, kwargs, out)
            return
        schema = func._schema
        outs = _tensors(out)
        if schema.returns and all(r.alias_info is not None and not r.alias_info.is_write
                                  for r in schema.returns):
            return  # a view: no new storage, nothing moved
        written = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written += _tensors(v)
        ins = _tensors((args, kwargs))
        if written:
            if any(self.is_other(t) for t in written):
                return
        elif any(self.is_other(t) for t in ins):
            for t in outs:
                self.other(t)
            return
        for t in outs:
            self.hold(t)
        if name in _ALLOCATIONS:
            return
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in _REDUCTIONS and ins:
            self.flops += ins[0].numel()
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)

    def _count_foreach(self, name, args, kwargs, out) -> None:
        lists = [a for a in (*args, *kwargs.values())
                 if isinstance(a, (list, tuple)) and a and isinstance(a[0], torch.Tensor)]
        outs = out if isinstance(out, (list, tuple)) else None
        base = name[len("_foreach_"):].rstrip("_")
        for i in range(len(lists[0])):
            ts = [lst[i] for lst in lists]
            if any(self.is_other(t) for t in ts):
                if outs is not None:
                    self.other(outs[i])
                continue
            written = outs[i] if outs is not None else ts[0]
            if outs is not None:
                self.hold(outs[i])
            n = ts[0].numel()
            self.flops += n
            if base in _TRANSCENDENTAL:
                self.transcendentals += n
            self.bytes += sum(_nbytes(t) for t in ts) + _nbytes(written)


# ---------------------------------------------------------------------------
# expert parallelism and the cells' steps


def _ep_info(mesh, cfg: ModelConfig, cell: ShapeCell, variant: str | None = None):
    """Expert-parallel dispatch parameters for MoE cells: tokens-per-device
    and per-(sender, expert) capacity with 1.25 slack (paper-style
    partitioned dispatch buckets).  variant "moe_ts" slices tokens over the
    model axis before dispatch (§Perf iteration 2)."""
    from repro_torch.parallel.sharding import dp_axes

    if not cfg.moe_num_experts:
        return None, "dense"
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    toks = cell.global_batch * (cell.seq_len if cell.mode != "decode" else 1)
    t_local = max(toks // dp_size, 1)
    token_slice = variant in ("moe_ts", "moe_ts2", "moe_ts3")
    if token_slice:
        t_local = max(t_local // mesh.shape["model"], 1)
    cap_factor = 1.0 if variant in ("moe_ts2", "moe_ts3") else 1.25
    cap = t_local * cfg.moe_top_k * cap_factor / cfg.moe_experts_padded
    cap = max(8, int((cap + 7) // 8 * 8))
    return {
        "mesh": mesh, "dp": dp, "capacity_per_expert": cap,
        "token_slice": token_slice,
        "quantize_dispatch": variant in ("moe_ts2", "moe_ts3"),
    }, "ep"


class CellStep(NamedTuple):
    """One cell's step for :func:`trace`: ``fn(*args)`` is the step;
    ``held`` the tensors the traced member (EP: group) holds as arguments;
    ``others`` the other members' parts the trace also holds; ``group``
    how many members the trace computes for (EP: a ``model`` group, else
    1); ``data_sum`` the float32 gradient bytes summed over the data axes
    (train with dp > 1, else 0); ``argument_bytes`` what a member holds by
    the production mesh's ``shard_shape``."""

    fn: Callable
    args: tuple
    held: list
    others: list
    group: int
    data_sum: int
    argument_bytes: int


def _dp_size(mesh) -> int:
    size = 1
    for a in sharding.dp_axes(mesh):
        size *= mesh.shape[a]
    return size


def _member_mesh(mesh) -> sharding.Mesh:
    """A (pod 1,) data 1, model M mesh of meta members: one data member and
    its ``model`` group, with the production mesh's axis names."""
    shape = tuple(mesh.shape[a] if a == "model" else 1 for a in mesh.axis_names)
    m = mesh.shape["model"]
    return sharding.make_mesh(shape, mesh.axis_names,
                              devices=[sharding.MeshDevice(i, META) for i in range(m)])


def _member_rows(mesh, b: int) -> int:
    """A data member's rows of a ``b``-row batch (all of them where the
    data axes do not divide it: the batch is replicated)."""
    dp = _dp_size(mesh)
    return b // dp if b % dp == 0 else b


def _shard_bytes(mesh, tree, specs) -> int:
    """Bytes one member holds of ``tree`` placed by ``specs`` on ``mesh``."""
    total = []

    def add(path, leaf, spec):
        shape = sharding.NamedSharding(mesh, spec).shard_shape(tuple(leaf.shape))
        n = 1
        for d in shape:
            n *= d
        total.append(n * leaf.element_size())
    sharding._map_with_path(add, tree, specs)
    return sum(total)


def _split_placed(tree) -> tuple:
    """``(held, others)``: the copies of a placed tree's leaves that member
    0 of its mesh holds, and the rest."""
    held, others = [], []

    def visit(path, leaf):
        own = leaf.sharding.index_of((0,) * leaf.sharding.mesh.devices.ndim, leaf.ndim)
        for (_, index), t in leaf.copies.items():
            (held if index == own else others).append(t)
    sharding._map_with_path(visit, tree)
    return held, others


def _gathered(tree, device):
    """Each placed leaf whole on ``device``: ``PlacedTensor.gathered``, a
    recorded all-gather where the leaf is split."""
    return tf.tree_map(lambda p: p.gathered(device), tree)


def _held_leaves(tree) -> list:
    """The tensors of a tree whose leaves may be placed: a placed leaf's
    copies, each storage once."""
    out, seen = [], set()

    def visit(path, leaf):
        for t in (leaf.copies.values() if isinstance(leaf, sharding.PlacedTensor)
                  else _tensors(leaf)):
            if _storage_key(t) not in seen:
                seen.add(_storage_key(t))
                out.append(t)
    sharding._map_with_path(visit, tree)
    return out


def _cut(t: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] = rows
    return torch.empty(shape, dtype=t.dtype, device=META)


def _member_args(mesh, params, trees_specs) -> int:
    """Bytes one member holds: the parameters by ``param_specs`` and each
    ``(tree, specs)`` by its specs, on the production ``mesh``."""
    total = _shard_bytes(mesh, params, sharding.param_specs(params))
    return total + sum(_shard_bytes(mesh, t, s) for t, s in trees_specs)


def _train_step(mesh, cfg: ModelConfig, cell: ShapeCell, variant, params, ep) -> CellStep:
    hp = loop.TrainHParams(ticketed_embedding=(variant == "ticketed"))
    batch_args, batch_specs = sp.batch_sds(cfg, cell, mesh)
    rows = _member_rows(mesh, cell.global_batch)
    batch = {k: _cut(v, rows) for k, v in batch_args.items()}
    moments = sp.abstract_opt(params)
    pspecs = sharding.param_specs(params)
    args_b = 4 + _member_args(mesh, params, [(moments.m, pspecs), (moments.v, pspecs),
                                             (batch_args, batch_specs)])
    data_sum = 4 * sum(t.numel() for t in _tensors(params)) if _dp_size(mesh) > 1 else 0
    m1 = _member_mesh(mesh)
    if ep is not None:
        step = loop.make_train_step(cfg, hp, moe_impl="ep", ep_info=dict(ep, mesh=m1))
        args = (params, moments, batch)
        return CellStep(step, args, _tensors(args), [], m1.size, data_sum, args_b)
    del moments
    placed = sharding.place(params, sharding.param_shardings(m1, params))
    opt = loop._placed_adamw_init(placed, m1)
    step = loop.jit_train_step(m1, cfg, hp, placed, opt)(batch)
    held, others = _split_placed((placed, opt))
    return CellStep(step, (placed, opt, batch), held + _tensors(batch), others, 1,
                    data_sum, args_b)


def _twobuf_caches(cfg: ModelConfig, cell: ShapeCell, mesh, batch: int, q8: bool):
    """The two-buffer decode layout (§Perf iteration 1): a frozen prefix,
    its sequence over ``model`` (int8 k/v under ``q8``), and a replicated
    tail, both split over the data axes on the batch."""
    dp = sharding.dp_axes(mesh)
    prefix, tail = tf.init_twobuf_caches(cfg, batch, cell.seq_len, 512,
                                         tf.torch_dtype(cfg.dtype), device=META)
    if q8:
        prefix = prefix._replace(k=torch.empty(prefix.k.shape, dtype=torch.int8, device=META),
                                 v=torch.empty(prefix.v.shape, dtype=torch.int8, device=META))

    def spec(seq_axis):
        return lambda path, leaf: ((None, dp, seq_axis, None, None)
                                   if path.split("/")[-1] in ("k", "v") else ())
    specs = (sharding._map_with_path(spec("model"), prefix),
             sharding._map_with_path(spec(None), tail))
    return (prefix, tail), specs


def _serve_step(mesh, cfg: ModelConfig, cell: ShapeCell, variant, params, ep) -> CellStep:
    """Prefill (``decode_step(..., last_only=True)`` with the caches, the
    encoder memory or the vision frontend: the reference's three branches)
    or decode (``decode_step`` and argmax, or ``decode_step_twobuf``) on
    one data member's rows."""
    b, s = cell.global_batch, cell.seq_len
    m1 = _member_mesh(mesh)
    dtype = tf.torch_dtype(cfg.dtype)
    twobuf = variant in ("twobuf", "twobuf_q8", "twobuf_q8w")
    if twobuf:
        assert cell.mode == "decode"
        q8 = variant != "twobuf"
        rows = _member_rows(mesh, b)
        whole, wspecs = _twobuf_caches(cfg, cell, mesh, b, q8)
        caches, cspecs = _twobuf_caches(cfg, cell, m1, rows, q8)
    else:
        whole, wspecs, seq_shard = sp.cache_sds(cfg, cell, mesh)
        rows = b if seq_shard else _member_rows(mesh, b)
        local = dataclasses.replace(cell, global_batch=rows)
        caches, cspecs, _ = sp.cache_sds(cfg, local, m1)
    tokens = torch.empty((rows, s if cell.mode == "prefill" else 1), dtype=torch.int32,
                         device=META)
    extra = {}
    if cfg.encoder_layers:
        extra["memory"] = torch.empty((rows, s, cfg.d_model), dtype=dtype, device=META)
    if cfg.frontend == "vision" and cell.mode == "prefill":
        extra["frontend_embeds"] = torch.empty((rows, cfg.frontend_tokens, cfg.d_model),
                                               dtype=torch.float32, device=META)
    more = list(extra.values())
    args_b = (_member_args(mesh, params, [(whole, wspecs)])
              + _nbytes(tokens) + sum(_nbytes(t) for t in more))
    moe_kw = {} if ep is None else {"moe_impl": "ep", "ep_info": dict(ep, mesh=m1)}

    def run(p, toks, c, *more_args):
        kw = dict(zip(extra, more_args))
        if twobuf:
            logits, new_tail = tf.decode_step_twobuf(p, cfg, toks, c[0], c[1])
            return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None], new_tail
        if cell.mode == "prefill":
            return tf.decode_step(p, cfg, toks, c, last_only=True, **kw, **moe_kw)
        # enc-dec archs decode against a fixed encoder memory (cross-attention)
        logits, c = tf.decode_step(p, cfg, toks, c, last_only=True, **kw,
                                   **({} if cfg.encoder_layers else moe_kw))
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None], c

    if ep is not None:  # one model group: whole parameters and caches
        args = (params, tokens, caches, *more)
        return CellStep(run, args, _tensors(args), [], m1.size, 0, args_b)
    placed = sharding.place(params, sharding.param_shardings(m1, params))
    pcaches = sharding.place(caches, sharding._map_with_path(
        lambda path, leaf, spec: sharding.NamedSharding(m1, spec), caches, cspecs))
    dev = m1.devices.reshape(-1)[0].device

    def member(p, toks, c, *more_args):
        return run(_gathered(p, dev), toks, _gathered(c, dev), *more_args)

    held, others = _split_placed((placed, pcaches))
    return CellStep(member, (placed, tokens, pcaches, *more), held + _tensors((tokens, more)),
                    others, 1, 0, args_b)


def lower_cell(mesh, cfg: ModelConfig, cell: ShapeCell, variant: str | None = None) -> CellStep:
    """The step of one cell (+ optional §Perf variant) for one member of
    ``mesh``, on meta tensors (see the module docstring)."""
    if variant in ("remat_dots", "moe_ts3"):
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    if variant == "remat_bf16logits":
        cfg = dataclasses.replace(cfg, remat_policy="dots", logits_dtype="bfloat16")
    params = sp.abstract_params(cfg)
    if variant == "twobuf_q8w":
        from repro_torch.models.layers import quantize_dense_params
        params = quantize_dense_params(params)
    ep_info, moe_impl = _ep_info(mesh, cfg, cell, variant)
    ep = ep_info if moe_impl == "ep" and variant not in ("twobuf", "twobuf_q8",
                                                          "twobuf_q8w") else None
    if cell.mode == "train":
        return _train_step(mesh, cfg, cell, variant, params, ep)
    return _serve_step(mesh, cfg, cell, variant, params, ep)


def trace(step: CellStep) -> dict:
    """Run ``step`` under :class:`CostMode`; a member's figures (the
    group's over its size)."""
    mode = CostMode()
    with mode:
        for t in step.others:
            mode.other(t)
        for t in step.held:
            mode.hold(t)
        held = mode.live
        out = step.fn(*step.args)
        outputs = sum(_nbytes(t) for t in _held_leaves(out) if not mode.is_other(t))
        peak = mode.peak
    del out
    n = step.group
    record = list(mode.record)
    if step.data_sum:
        record.append(("all-reduce", step.data_sum))
    coll = collective_bytes(record)
    per = {k: v / n for k, v in coll.items() if k != "counts"}
    per["counts"] = coll["counts"]
    return {
        "memory": {
            "argument_bytes": step.argument_bytes,
            "output_bytes": outputs // n,
            "temp_bytes": (peak - held) // n,
            "peak_bytes": peak // n,
            "peak_exact": True,
        },
        "cost": {"flops": mode.flops / n, "bytes accessed": mode.bytes / n,
                 "transcendentals": mode.transcendentals / n},
        "collectives": per,
    }


def _unrolled_sibling(cfg: ModelConfig, k: int) -> ModelConfig:
    """A k-scan-iteration sibling with every scan unrolled, for cost
    extrapolation (XLA cost_analysis counts while bodies ONCE — see the
    calibration note in EXPERIMENTS.md §Roofline)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every * k, scan_unroll=True)
    if cfg.encoder_layers:
        return dataclasses.replace(cfg, n_layers=k, encoder_layers=k, scan_unroll=True)
    return dataclasses.replace(cfg, n_layers=k, scan_unroll=True)


def _scan_scale(cfg: ModelConfig) -> float:
    """Real scan trip count the k=1 body must be scaled to."""
    if cfg.family == "hybrid":
        return cfg.n_layers / cfg.attn_every
    return float(cfg.n_layers)


def _measure(mesh, cfg, cell, variant=None):
    res = trace(lower_cell(mesh, cfg, cell, variant))
    return res, res["cost"], res["collectives"]


def extrapolated_cost(mesh, cfg: ModelConfig, cell: ShapeCell, variant=None):
    """total(L) = fixed + L·body via two small unrolled traces."""
    _, c1, k1 = _measure(mesh, _unrolled_sibling(cfg, 1), cell, variant)
    _, c2, k2 = _measure(mesh, _unrolled_sibling(cfg, 2), cell, variant)
    scale = _scan_scale(cfg)

    def extrap(a, b):
        body = max(b - a, 0.0)
        fixed = max(a - body, 0.0)
        return fixed + scale * body

    cost = {
        k: extrap(float(c1.get(k, 0.0) or 0.0), float(c2.get(k, 0.0) or 0.0))
        for k in ("flops", "bytes accessed", "transcendentals")
    }
    coll = {
        k: extrap(float(k1.get(k, 0)), float(k2.get(k, 0)))
        for k in k1
        if k != "counts"
    }
    return cost, coll


def run_cell(arch: str, shape: str, *, multi_pod: bool = False, verbose: bool = True,
             with_cost: bool = True, variant: str | None = None):
    cfg = get_config(arch)
    cell = SHAPES[shape]
    chips = 512 if multi_pod else 256
    with sharding.virtual_devices(chips, META):
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    step = lower_cell(mesh, cfg, cell, variant)
    t_lower = time.time() - t0
    raw = trace(step)
    del step
    t_compile = time.time() - t0 - t_lower
    raw_cost, raw_coll = raw["cost"], raw["collectives"]
    if with_cost:
        cost, coll = extrapolated_cost(mesh, cfg, cell, variant)
    else:
        cost, coll = raw_cost, raw_coll
    terms = derive_terms(
        arch=arch,
        shape=shape,
        mesh_name=mesh_name,
        chips=chips,
        cost=cost,
        coll=coll,
        model_flops=model_flops_estimate(cfg, cell),
    )
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "mode": cell.mode,
        "variant": variant,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": raw["memory"],
        "cost": {k: cost.get(k) for k in ("flops", "bytes accessed", "transcendentals")},
        "cost_raw_scanned": {
            k: raw_cost.get(k) for k in ("flops", "bytes accessed", "transcendentals")
        },
        "collectives": coll,
        "collectives_raw_scanned": raw_coll,
        "roofline": terms.to_dict(),
    }
    if verbose:
        ma = result["memory"]
        print(
            f"[{arch} × {shape} × {mesh_name}] OK  "
            f"lower {t_lower:.0f}s trace {t_compile:.0f}s  "
            f"peak/member {(ma['peak_bytes'] or 0)/2**30:.2f} GiB  "
            f"flops {terms.hlo_flops:.3e}  coll {terms.coll_bytes:.3e} B  "
            f"bottleneck={terms.bottleneck}",
            flush=True,
        )
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="§Perf variant: twobuf | moe_ts | ticketed")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells: list[Any] = []
    if args.all:
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for cell in applicable_shapes(cfg):
                cells.append((arch, cell.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
            if args.variant:
                tag += f"__{args.variant}"
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[{tag}] cached, skipping", flush=True)
                continue
            try:
                res = run_cell(arch, shape, multi_pod=mp, variant=args.variant)
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=1)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((tag, repr(e)))
                print(f"[{tag}] FAILED: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
