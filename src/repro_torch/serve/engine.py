"""Serving: batched prefill + decode with KV caches.

Port of ``repro.serve.engine``.  ``make_serve_step`` builds the one-token
decode step: tokens (B,1) + caches → next tokens (B,1) (greedy argmax on
the device) + logits (B,1,V) + caches.  The step writes the attention
caches in place, as the reference donates them.

The host-side ``ServeLoop`` is a thin adapter over the port's slot
scheduler (``serve/scheduler.py``), as the reference's rides its own:
each request becomes a ``SlotTask`` sharing one lock-step decode batch,
the scheduler owns admission/stepping/release, and the shared
``batch_key`` group dispatch keeps the whole batch advancing as ONE decode
step per round.

Placement (the reference's ``serve_cache_shardings`` and
``jit_serve_step``): on a mesh of one member, parameters and caches are
plain tensors on that member's device and the loop calls
``make_serve_step`` directly, with no per-step placement work.  On a mesh
of more members the parameters are placed by ``param_shardings`` and the
caches by ``serve_cache_shardings`` (``parallel.sharding.cache_specs``),
one tensor per (device, part), and the loop steps through
:func:`jit_serve_step`, whose compute is not partitioned: each data
member gathers the parameters and its rows' cache parts, runs the decode
step, and writes what the step changed back into the parts in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding


def serve_cache_shardings(mesh, cfg: ModelConfig, caches, *, seq_shard: bool = False):
    """A ``sharding.NamedSharding`` for each cache leaf: ``cache_specs``',
    or with ``seq_shard`` (a batch too small for the data axes) the
    sequence of every leaf of rank >= 4 (the k/v tensors (..., B, S, KVH,
    hd); states of that rank take the same rule, as in the reference) over
    ALL mesh axes and every other leaf replicated."""
    specs = sharding.cache_specs(mesh, cfg, caches)
    if seq_shard:
        axes = tuple(mesh.axis_names)
        every = axes if len(axes) > 1 else axes[0]
        specs = sharding._map_with_path(
            lambda path, leaf, spec: ((None,) * (len(leaf.shape) - 3) + (every, None, None)
                                      if len(leaf.shape) >= 4 else ()), caches, specs)
    return sharding._map_with_path(
        lambda path, leaf, spec: sharding.NamedSharding(mesh, spec), caches, specs)


def make_serve_step(cfg: ModelConfig, *, memory=None):
    def serve_step(params, tokens, caches):
        logits, caches = tf.decode_step(params, cfg, tokens, caches, memory=memory)
        # greedy sampling on the device (argmax); temperature sampling is a
        # host-side concern in this engine
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, caches

    return serve_step


def _batch_dim(path: str, ndim: int):
    """The batch dim of a cache leaf by ``cache_specs``' names (None for
    ``length`` and leaves it does not name)."""
    if ndim == 0 or "length" in path:
        return None
    if path.split("/")[-1] in ("k", "v") or "state" in path:
        return ndim - 4
    if "conv" in path and ndim >= 3:
        return ndim - 3
    if "last_x" in path and ndim >= 2:
        return ndim - 2
    return None


def _region(placed, index, bdim, rows, seq=None):
    """Where part ``index`` of ``placed`` meets a member's region (batch
    rows ``rows`` on ``bdim``, every other dim whole; ``seq`` = (dim, lo,
    hi) narrows one more dim): ``(slices into the part, slices into the
    member's tensor)``, or None where they do not meet."""
    part, member = [], []
    for dim, g in enumerate(placed.part_slices(index)):
        lo, hi, off = g.start, g.stop, 0
        if dim == bdim:
            lo, hi, off = max(lo, rows[0]), min(hi, rows[1]), rows[0]
        elif seq is not None and dim == seq[0]:
            lo, hi = max(lo, seq[1]), min(hi, seq[2])
        if lo >= hi:
            return None
        part.append(slice(lo - g.start, hi - g.start))
        member.append(slice(lo - off, hi - off))
    return tuple(part), tuple(member)


def _gather_rows(placed, bdim, rows, device) -> torch.Tensor:
    """Batch rows ``rows`` of a placed cache leaf, whole in every other dim,
    on ``device``: the part itself where one part on ``device`` is exactly
    that (a step then writes the part in place), else a fresh tensor
    assembled from one copy of each part."""
    want = [(rows[0], rows[1]) if i == bdim else (0, n) for i, n in enumerate(placed.shape)]
    for (dev, index), part in placed.copies.items():
        if dev == str(device) and [(g.start, g.stop) for g in placed.part_slices(index)] == want:
            return part
    out = torch.empty([b - a for a, b in want], dtype=placed.dtype, device=device)
    done = set()
    for (dev, index), part in sorted(placed.copies.items(), key=lambda kv: kv[0][0] != str(device)):
        hit = None if index in done else _region(placed, index, bdim, rows)
        if hit is not None:
            out[hit[1]] = part[hit[0]].to(device)
            done.add(index)
    return out


def _write_back(placed, new, bdim, rows, seq=None) -> None:
    """Copy the member's ``new`` (its rows on ``bdim``) into every part of
    ``placed`` it meets, in place; ``seq`` narrows the copy to the
    positions a step wrote.  A part that is ``new``'s own storage is
    skipped."""
    for (_, index), part in placed.copies.items():
        hit = _region(placed, index, bdim, rows, seq)
        if hit is not None:
            dst, src = part[hit[0]], new[hit[1]]
            if dst.data_ptr() != src.data_ptr() or dst.device != src.device:
                dst.copy_(src)


def _flat(tree) -> dict:
    out = {}
    sharding._map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def jit_serve_step(mesh, cfg: ModelConfig, params, caches, *, seq_shard=False, with_memory=False,
                   memory=None):
    """The reference's jitted serve step over ``mesh``: ``step(params,
    tokens, caches) -> (next tokens (B, 1), logits (B, S, V) whole, placed
    caches)``.

    ``params`` and ``caches`` (plain or placed; only paths and shapes are
    read here) fix the placement: parameters by ``param_shardings``,
    caches by :func:`serve_cache_shardings`.  A shape the placement does
    not divide raises ``ValueError`` here, as the reference's pjit refuses
    it.  The step places what it is given by that (a no-op for what it
    returned), one tensor per (device, part) as ``sharding.place`` holds
    it.  Tokens (and ``memory``'s rows) split over ``dp_axes(mesh)`` in
    member order; with ``seq_shard`` they are whole and the first member
    computes.

    The compute is not partitioned, as ``train.loop.jit_train_step``'s:
    each data member (index 0 of ``model``) gathers the whole parameters
    on its device (kept across steps while the placed parameters are the
    same tensors, unwritten) and its rows' cache parts, runs
    :func:`make_serve_step`, and after every member has stepped the
    changes are written back into the parts in place (``copy_``): the k/v
    positions the step appended, and every other leaf (``length``, SSM and
    RWKV states) whole.  So the cache held stays one copy a part and no
    part is reallocated.  Next tokens and logits are gathered on the first
    member's device.  ``with_memory`` is the reference's unused flag."""
    del with_memory
    psh = sharding.param_shardings(mesh, params)
    csh = serve_cache_shardings(mesh, cfg, caches, seq_shard=seq_shard)
    for tree, shardings in ((params, psh), (caches, csh)):
        sharding._map_with_path(
            lambda path, leaf, sh: sharding.check_divides(leaf.shape, sh, path), tree, shardings)
    members = ([mesh.devices.reshape(-1)[0]] if seq_shard else
               list(sharding.member_grid(mesh, sharding.dp_axes(mesh)).reshape(-1)))
    home = members[0].device
    gathered: dict = {}  # "stamp": the placed parameters' identity and versions; device -> tree

    def step(params, tokens, caches):
        params = sharding.place(params, psh)
        caches = sharding.place(caches, csh)
        p_leaves = list(tf._leaves(params))
        stamp = tuple((id(p), tuple(t._version for t in p.copies.values())) for p in p_leaves)
        if gathered.get("stamp") != stamp:
            gathered.clear()
            gathered["stamp"] = stamp

        def params_on(device):
            if str(device) not in gathered:
                it = iter([p.gathered(device) for p in p_leaves])
                gathered[str(device)] = tf.tree_map(lambda _: next(it), params)
            return gathered[str(device)]

        n, b, s_new = len(members), tokens.shape[0], tokens.shape[1]
        if b % n:
            raise ValueError(f"{b} token rows do not split over {n} data-parallel members")
        leaves = _flat(caches)
        bdims = {path: _batch_dim(path, leaf.ndim) for path, leaf in leaves.items()}
        seqs = {}  # k/v path -> (seq dim, first, end) of the positions the step writes
        for path, leaf in leaves.items():
            if path.split("/")[-1] in ("k", "v"):
                length = leaves[path.rsplit("/", 1)[0] + "/length" if "/" in path else "length"]
                lens = next(iter(length.copies.values())).reshape(-1).tolist()
                s_max = leaf.shape[bdims[path] + 1]
                lo = min(max(min(lens), 0), s_max - s_new)
                hi = min(max(max(lens), 0), s_max - s_new) + s_new
                seqs[path] = (bdims[path] + 1, lo, hi)
        done = []
        for i, m in enumerate(members):
            rows = (i * (b // n), (i + 1) * (b // n))
            dev = m.device
            mine = {path: _gather_rows(leaf, bdims[path], rows, dev)
                    for path, leaf in leaves.items()}
            it = iter(mine[path] for path in leaves)
            c_m = tf.tree_map(lambda _: next(it), caches)
            mem = None if memory is None else memory[rows[0]:rows[1]].to(dev)
            out = make_serve_step(cfg, memory=mem)(params_on(dev),
                                                   tokens[rows[0]:rows[1]].to(dev), c_m)
            done.append((rows, mine, out))
        for i, (rows, mine, (_, _, new)) in enumerate(done):
            for path, value in _flat(new).items():
                bdim = bdims[path]
                if path in seqs:  # appended in place into mine[path]
                    _write_back(leaves[path], mine[path], bdim, rows, seqs[path])
                elif bdim is not None or i == 0:  # a leaf without rows: the first member's
                    _write_back(leaves[path], value, bdim, rows if bdim is not None else None)
        next_tok = torch.cat([o[0].to(home) for _, _, o in done])
        logits = torch.cat([o[1].to(home) for _, _, o in done])
        return next_tok, logits, caches

    return step


@dataclass
class Request:
    uid: int
    prompt: Any  # (S,) int token ids: a tensor, array or list
    max_new: int
    generated: list = field(default_factory=list)
    done: bool = False


class _DecodeTask:
    """``SlotTask`` face of one request inside a lock-step decode batch.

    All tasks of one :class:`_LockstepDecoder` share its ``batch_key``, so
    the scheduler co-dispatches them: one ``step_batch`` call advances the
    WHOLE batch one decode step, and each task only owns its request's
    per-slot bookkeeping (append token, notice budget exhaustion, release
    on cancel)."""

    def __init__(self, decoder: "_LockstepDecoder", row: int, request: Request):
        self.decoder, self.row, self.request = decoder, row, request
        self.cancelled = False

    @property
    def batch_key(self):
        return id(self.decoder)

    @property
    def done(self) -> bool:
        return self.request.done or self.cancelled

    def step(self) -> None:
        # lock-step: a solo step still advances the shared batch (the KV
        # cache carries one write position — there is no per-slot clock)
        self.decoder.tick()

    @staticmethod
    def step_batch(tasks: list["_DecodeTask"]) -> None:
        tasks[0].decoder.tick()

    def finish(self) -> Request:
        return self.request

    def cancel(self) -> None:
        self.cancelled = True  # the decoder stops appending to this slot


class _LockstepDecoder:
    """Shared decode state for one admitted batch: prompts right-padded to
    a common length and prefilled token-by-token through the SAME decode
    step generation uses.  Every ``tick`` appends the current greedy token
    to each live request (one device read a tick) and runs one decode step
    for the whole batch."""

    def __init__(self, loop: "ServeLoop", requests: list[Request]):
        self.loop = loop
        self.tasks = [_DecodeTask(self, i, r) for i, r in enumerate(requests)]
        loop._reset()
        dev = loop.device
        rows = [torch.as_tensor(r.prompt, dtype=torch.int32).reshape(-1).to(dev) for r in requests]
        plen = max(int(r.shape[0]) for r in rows)
        prompts = torch.zeros((loop.slots, plen), dtype=torch.int32, device=dev)
        for i, r in enumerate(rows):
            prompts[i, : r.shape[0]] = r
        next_tok = prompts[:, :1]
        for t in range(plen):
            tokens = prompts[:, t: t + 1]
            next_tok, _, loop.caches = loop.step_fn(loop.params, tokens, loop.caches)
        self.tokens = next_tok

    def tick(self) -> None:
        current = self.tokens[:, 0].tolist()
        for task in self.tasks:
            if task.done:
                continue
            r = task.request
            r.generated.append(int(current[task.row]))
            if len(r.generated) >= r.max_new:
                r.done = True
        if any(not t.done for t in self.tasks):
            self.tokens, _, self.loop.caches = self.loop.step_fn(
                self.loop.params, self.tokens, self.loop.caches
            )


class ServeLoop:
    """Lock-step batched serving over a fixed slot grid — a thin client of
    the slot scheduler (``serve/scheduler.py``).

    All slots advance together (the KV cache carries one shared write
    position), which the scheduler expresses as one ``batch_key`` group:
    every request is its own ``SlotTask``, admission/stepping/release run
    through ``Scheduler``, and each scheduling round advances the whole
    batch one decode step.  Admission stays batch-granular, as in the
    reference.

    ``mesh`` is any ``parallel.sharding.Mesh`` with ``data`` and ``model``
    axes.  On one member the loop steps ``make_serve_step`` on plain
    tensors; on more it places the parameters by ``param_shardings`` and
    the caches by ``serve_cache_shardings`` and steps through
    :func:`jit_serve_step`, as the reference; ``slots`` must then split
    over the data-parallel members.  A shape the placement does not divide
    raises ``ValueError``.
    """

    def __init__(self, mesh, cfg: ModelConfig, params, *, slots: int, max_len: int):
        members = list(mesh.devices.reshape(-1))
        self.mesh, self.cfg = mesh, cfg
        self.device = members[0].device
        self.slots = slots
        self.max_len = max_len
        self.caches = None
        if len(members) == 1:  # plain tensors on the member: no per-step placement work
            self.params = tf.tree_map(lambda t: t.to(self.device), params)
            self.step_fn = make_serve_step(cfg)
        else:
            self.params = sharding.place(params, sharding.param_shardings(mesh, params))
            self.step_fn = None
        self._reset()

    def _reset(self):
        """Fresh caches: new tensors on one member; over more, the placed
        parts zeroed in place (placed and ``jit_serve_step`` built on the
        first call, as the reference builds its step)."""
        if self.caches is not None and sharding.is_placed(self.caches):
            for leaf in tf._leaves(self.caches):
                for t in leaf.copies.values():
                    t.zero_()
            return
        caches = tf.init_caches(self.cfg, self.slots, self.max_len,
                                tf.torch_dtype(self.cfg.dtype), device=self.device)
        if self.step_fn is None:
            self.step_fn = jit_serve_step(self.mesh, self.cfg, self.params, caches)
            caches = sharding.place(caches, serve_cache_shardings(self.mesh, self.cfg, caches))
        self.caches = caches

    def run_batch(self, requests: list[Request]) -> list[Request]:
        from repro_torch.serve.scheduler import Scheduler

        if len(requests) > self.slots:
            raise ValueError(f"{len(requests)} requests for {self.slots} slots")
        sched = Scheduler(slots=self.slots)
        decoder = _LockstepDecoder(self, requests)
        for task, r in zip(decoder.tasks, requests):
            sched.submit(task, tenant=f"req-{r.uid}")
        sched.run_until_idle()
        return requests
