"""Training steps and loop (port of ``repro.train.loop``).

``make_train_step(cfg, hp)`` builds ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``: ``transformer.lm_loss``, the
gradient of every parameter leaf by ``torch.autograd.grad``,
``clip_by_global_norm``, ``warmup_cosine(opt_state.step)`` and
``adamw.update``, as the reference's step.  The parameters and the AdamW
state are updated IN PLACE (``optim/adamw.py``) and returned; the metrics
are 0-d tensors on the device, so a step reads nothing back to the host.
With ``TrainHParams.ticketed_embedding`` the embedding's gradient runs the
paper's pipeline (``models/layers.py`` ``ticketed_embed_grad``: the ticket
kernel, kernel B5, one ``index_add_``).

``make_manual_dp_step(mesh, cfg, hp)`` is the reference's shard_map
data-parallel step on the port's single-controller mesh: parameters
replicated, the batch split over ``dp_axes(mesh)`` in member order, each
member's gradients by ``torch.autograd.grad``, averaged over ``data`` in
float32 and over ``pod`` by a mean or, under ``grad_compression="int8"``,
``optim.compression.compressed_psum`` / npod; then one clip, schedule and
AdamW update.  ``grad_compression`` is read only by that step, so
``make_train_step`` ignores it, as the reference's does.

``jit_train_step(mesh, cfg, hp, params, opt_state)`` is the reference's
pjit step on the single-controller mesh: parameters and AdamW moments
placed by ``parallel.sharding.param_specs`` (one copy a device and part),
the batch split over ``dp_axes(mesh)``, and exactly one loss, gradient,
clip, schedule and AdamW update of the whole batch a step: the members'
objectives are their shares of the whole batch's loss, masked ``nll`` and
MoE load-balance loss included (see its docstring).  The compute is not partitioned over ``model``: each
data-parallel member gathers the whole parameters.

``train_loop`` runs on any ``parallel.sharding.Mesh``: data → step →
metrics → periodic checkpoints, resuming from the manager's latest
commit.  On one member it runs ``make_train_step`` on plain tensors; on
more it places the state and runs ``jit_train_step``, as the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.compression import compressed_psum
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel import sharding


@dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    ticketed_embedding: bool = True
    grad_compression: str | None = None  # None | "int8" (manual_dp mode)


def make_loss_fn(cfg: ModelConfig, hp: TrainHParams, *, moe_impl="dense",
                 ep_info=None) -> Callable:
    def loss_fn(params, batch):
        return tf.lm_loss(
            params, cfg, batch, ticketed_embedding=hp.ticketed_embedding,
            moe_impl=moe_impl, ep_info=ep_info,
        )

    return loss_fn


def make_train_step(cfg: ModelConfig, hp: TrainHParams, *, moe_impl="dense", ep_info=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)`` (see the module docstring); ``metrics`` holds ``loss``,
    ``nll``, ``aux``, ``grad_norm`` and ``lr``."""
    loss_fn = make_loss_fn(cfg, hp, moe_impl=moe_impl, ep_info=ep_info)

    def train_step(params, opt_state, batch):
        # detached views that require grad: the caller's tensors keep their
        # flags, and the in-place update below writes what the views share
        tree = tf.tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(tree, batch)
        flat = iter(torch.autograd.grad(loss, list(tf._leaves(tree))))
        grads = tf.tree_map(lambda _: next(flat), params)
        del tree
        grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
        lr = warmup_cosine(
            opt_state.step, peak_lr=hp.peak_lr, warmup=hp.warmup, total=hp.total_steps
        )
        opt_state, params = adamw.update(
            opt_state, grads, params, lr=lr, weight_decay=hp.weight_decay
        )
        out_metrics = {
            "loss": loss.detach(),
            "nll": metrics["nll"].detach(),
            "aux": metrics["aux"].detach(),
            "grad_norm": gnorm,
            "lr": lr,
        }
        return params, opt_state, out_metrics

    return train_step


def _dp_grid(mesh) -> list:
    """The members that compute, one per data-parallel coordinate (index 0
    on every other axis): a list over pods (one pod without a pod axis) of
    lists over ``data``, in member order."""
    grid = sharding.member_grid(mesh, sharding.dp_axes(mesh))
    return [list(row) for row in grid.reshape(-1, mesh.shape["data"])]


def _split_batch(batch, n: int, split=None) -> list:
    """``batch`` as ``n`` parts, one a data-parallel member in member
    order: dim 0 of each key in ``split`` (default: every key) cut into
    ``n`` equal contiguous parts, the other keys whole in every part."""
    split = set(batch) if split is None else split
    for k, v in batch.items():
        if k in split and v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, which do not split over "
                             f"{n} data-parallel members")
    cut = {k: v.tensor_split(n) if k in split else [v] * n for k, v in batch.items()}
    return [{k: c[i] for k, c in cut.items()} for i in range(n)]


def _member_grads(loss_fn, tree, batch):
    """``(loss, nll, aux, float32 gradients in leaf order)`` of one
    member's batch part, on detached views of ``tree``'s tensors."""
    tree = tf.tree_map(lambda t: t.detach().requires_grad_(True), tree)
    loss, metrics = loss_fn(tree, batch)
    grads = torch.autograd.grad(loss, list(tf._leaves(tree)))
    return (loss.detach(), metrics["nll"].detach(), metrics["aux"].detach(),
            [g.float() for g in grads])


def _trees_on(params) -> Callable:
    """``dev -> the whole parameters on dev``: a plain tree itself; of a
    placed tree, the copy gathered on ``dev`` (one a device, kept until
    the returned function is dropped)."""
    if not sharding.is_placed(params):
        return lambda dev: params
    trees: dict = {}

    def on(dev):
        if str(dev) not in trees:
            it = iter([p.gathered(dev) for p in tf._leaves(params)])
            trees[str(dev)] = tf.tree_map(lambda _: next(it), params)
        return trees[str(dev)]

    return on


def _apply_update(params, opt_state, flat, hp: TrainHParams, home):
    """One ``clip_by_global_norm``, ``warmup_cosine`` and AdamW update from
    the float32 gradient ``flat`` (leaf order, on ``home``): a plain tree in
    place, as ``make_train_step``'s; a placed tree copy by copy
    (:func:`_update_placed`).  Returns ``(params, opt_state, gnorm, lr)``."""
    it = iter(flat)
    grads = tf.tree_map(lambda _: next(it), params)
    grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
    placed = sharding.is_placed(params)
    step = _placed_step_copy(opt_state, home) if placed else opt_state.step
    lr = warmup_cosine(step, peak_lr=hp.peak_lr, warmup=hp.warmup, total=hp.total_steps)
    if placed:
        _update_placed(params, opt_state, grads, lr, hp.weight_decay)
    else:
        opt_state, params = adamw.update(opt_state, grads, params, lr=lr,
                                         weight_decay=hp.weight_decay)
    return params, opt_state, gnorm, lr


def _opt_shardings(mesh, opt_state):
    """The reference's AdamW placement: ``step`` replicated, each moment
    placed as its parameter."""
    return adamw.AdamWState(step=sharding.NamedSharding(mesh, ()),
                            m=sharding.param_shardings(mesh, opt_state.m),
                            v=sharding.param_shardings(mesh, opt_state.v))


def _placed_adamw_init(params, mesh):
    """``adamw.init`` of a placed tree: a replicated 0-d step and zero
    float32 moments placed as their parameters, copy for copy."""
    zeros = lambda p: p.map(lambda t: torch.zeros(t.shape, dtype=torch.float32,  # noqa: E731
                                                  device=t.device))
    step = sharding.place_leaf(torch.zeros((), dtype=torch.int32),
                               sharding.NamedSharding(mesh, ()))
    return adamw.AdamWState(step=step, m=tf.tree_map(zeros, params),
                            v=tf.tree_map(zeros, params))


def _placed_step_copy(opt_state, device) -> torch.Tensor:
    return opt_state.step.copies[(str(device), ())]


def _update_placed(params, opt_state, grads, lr, weight_decay: float) -> None:
    """The AdamW update of every (device, part) copy of the placed
    parameters and moments, in place, once: each copy takes its slice of
    the whole gradient, and each device's copy of ``step`` advances once."""
    by_dev: dict = {}
    for p, m, v, g in zip(tf._leaves(params), tf._leaves(opt_state.m),
                          tf._leaves(opt_state.v), tf._leaves(grads)):
        for key, pc in p.copies.items():
            ps, ms, vs, gs = by_dev.setdefault(key[0], ([], [], [], []))
            ps.append(pc)
            ms.append(m.copies[key])
            vs.append(v.copies[key])
            gs.append(g[p.part_slices(key[1])].to(pc.device))
    for dev, (ps, ms, vs, gs) in by_dev.items():
        step = opt_state.step.copies[(dev, ())]
        adamw.update(adamw.AdamWState(step, tuple(ms), tuple(vs)), tuple(gs), tuple(ps),
                     lr=lr.to(step.device), weight_decay=weight_decay)


def _whole_batch_grads(cfg: ModelConfig, loss_fn, trees_on, members, parts, home):
    """The loss of the whole batch split over ``members`` (``parts`` in
    member order, equal rows) and its float32 gradient, summed on ``home``
    in member order: ``(grads in leaf order, loss, nll, aux)``.

    Each member's objective is its share of the whole batch's: its mean
    ``nll`` weighted by its valid targets over the batch's (``targets <
    0`` are masked, as ``lm_loss`` masks them), plus its term of the
    batch's load-balance loss (``moe.split_aux``).  The aux terms need
    every member's router counts, so under MoE every member's forward runs
    before any backward; otherwise each member's backward follows its
    forward and its activations are freed before the next member's."""
    valid = [(part["targets"] >= 0).sum().to(home) for part in parts]
    whole = torch.clamp(sum(valid), min=1)
    total, nll_sum, waiting = None, None, []

    def add(objective, view):
        nonlocal total
        grads = torch.autograd.grad(objective, list(tf._leaves(view)))
        grads = [g.float().to(home) for g in grads]
        if total is None:
            total = grads
        else:  # the float32 sum over the members, in member order
            torch._foreach_add_(total, grads)

    for member, part, count in zip(members, parts, valid):
        dev = member.device
        view = tf.tree_map(lambda t: t.detach().requires_grad_(True), trees_on(dev))
        with moe.router_stats() as stats:
            _, metrics = loss_fn(view, {k: v.to(dev) for k, v in part.items()})
        weight = (torch.clamp(count, min=1) / whole).to(dev)
        nll = metrics["nll"] * weight
        nll_sum = nll.detach().to(home) + (0 if nll_sum is None else nll_sum)
        if stats:
            waiting.append((view, nll, stats))
        else:
            add(nll, view)
        del view, metrics
    aux = torch.zeros((), dtype=torch.float32, device=home)
    if waiting:
        terms = moe.split_aux(cfg, [w[2] for w in waiting])
        for (view, nll, _), term in zip(waiting, terms):
            aux = aux + term.detach().to(home)
            add(nll + term, view)
        del waiting, view, nll
    return total, nll_sum + aux, nll_sum, aux


_BATCH_SPLIT = ("tokens", "targets", "frontend_embeds", "encoder_frames")


def jit_train_step(mesh, cfg: ModelConfig, hp: TrainHParams, params, opt_state):
    """The reference's pjit step: returns ``compile_step(batch_tree)``,
    which gives ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` over ``mesh``.

    ``params`` and ``opt_state`` (plain or placed; only their paths and
    shapes are read here) fix the placement: parameters by
    ``param_shardings``, the AdamW moments as their parameters, ``step``
    replicated.  The step places what it is given by that (a no-op for the
    state it returned) and returns the state placed.  The batch's
    ``tokens``, ``targets``, ``frontend_embeds`` and ``encoder_frames`` are
    split along dim 0 over ``dp_axes(mesh)`` in member order, equal parts
    (uneven parts raise, as the manual-dp step); any other key goes whole
    to every part.

    A step computes what ``make_train_step`` computes on the whole batch:
    each data-parallel member (index 0 of ``model``) gathers the whole
    parameters on its device (members on one device share one gathered
    copy) and takes the gradient of its share of the whole batch's loss by
    ``torch.autograd.grad`` (:func:`_whole_batch_grads`: the masked mean
    ``nll`` and the MoE load-balance loss of the whole batch, not the
    members' mean); the float32 sum of the members' gradients is the
    whole batch's.  Then one global norm and clip, one ``warmup_cosine``
    and the AdamW update of each (device, part) copy of the parameters and
    moments with its slice of the one gradient, in place.  The gathered
    copies are freed before the update.  Metrics ``loss``, ``nll``,
    ``aux``, ``grad_norm`` and ``lr`` are the whole batch's, 0-d tensors
    on the first member's device."""
    pshard = sharding.param_shardings(mesh, params)
    oshard = _opt_shardings(mesh, opt_state)
    members = [m for row in _dp_grid(mesh) for m in row]
    home = members[0].device
    loss_fn = make_loss_fn(cfg, hp)

    def compile_step(batch_tree):
        keys = set(batch_tree)
        split = {k for k in keys if k in _BATCH_SPLIT}

        def step(params, opt_state, batch):
            if set(batch) != keys:
                raise ValueError(f"the step was compiled for batch keys {sorted(keys)}, "
                                 f"given {sorted(batch)}")
            parts = _split_batch(batch, len(members), split)
            params = sharding.place(params, pshard)
            opt_state = sharding.place(opt_state, oshard)
            grads, loss, nll, aux = _whole_batch_grads(cfg, loss_fn, _trees_on(params),
                                                       members, parts, home)
            params, opt_state, gnorm, lr = _apply_update(params, opt_state, grads, hp, home)
            return params, opt_state, {"loss": loss, "nll": nll, "aux": aux,
                                       "grad_norm": gnorm, "lr": lr}

        return step

    return compile_step


def make_manual_dp_step(mesh, cfg: ModelConfig, hp: TrainHParams):
    """The reference's shard_map data-parallel step: ``wrapped(params,
    opt_state, batch) -> (params, opt_state, {"loss", "grad_norm", "lr"})``.

    Parameters are replicated and the batch split along dim 0 over
    ``dp_axes(mesh)`` in member order (member (pod p, data d) takes part
    ``p · ndata + d``; members of other axes compute what index 0 of them
    computes, so only those run).  Each member takes its loss and gradients
    on its own device with ``torch.autograd.grad``; the gradients are
    averaged over ``data`` in float32, then over ``pod``: a mean, or under
    ``grad_compression="int8"`` ``compressed_psum`` / npod (on a mesh with a
    pod axis, even of one member, as the reference).  Then
    ``clip_by_global_norm``, ``warmup_cosine`` and ``adamw.update``.  Each
    member's loss is its part's own (its MoE load-balance loss too), as
    under the reference's shard_map.

    Where every member sits on the device of a plain ``params`` tree (the
    virtual members of one device), the parameters stay that one copy:
    the members read it and the update writes it ONCE, in place, as
    ``make_train_step``'s.  Otherwise, or for a placed tree, each device
    that holds a member holds one copy (``sharding.place`` with the
    all-whole spec; a plain tree is placed so on the first call and the
    placed tree returned): each member computes on its device's copy, the
    one mean gradient is taken and clipped on the first member's device,
    and every device's copy takes the same AdamW update from it.  A member
    on a CUDA device where no card exists raises ``RuntimeError`` before
    any member computes.  ``loss`` is the mean over ``data`` of the first
    pod's members: the reference reduces the loss over ``data`` only, and
    its replicated output reads the first member's value."""
    loss_fn = make_loss_fn(cfg, hp)
    dp = sharding.dp_axes(mesh)
    grid = _dp_grid(mesh)
    npod, ndata = len(grid), len(grid[0])
    compress = "pod" in dp and hp.grad_compression == "int8"
    everywhere = sharding.NamedSharding(mesh, ())

    def wrapped(params, opt_state, batch):
        parts = _split_batch(batch, npod * ndata)
        placed = sharding.is_placed(params)
        if not placed:
            home = next(iter(tf._leaves(params))).device
            placed = any(m.device.type != home.type or m.device.index not in (None, home.index)
                         for row in grid for m in row)
        if placed:
            params = sharding.place(params, everywhere)
            opt_state = sharding.place(opt_state, everywhere)
            home = grid[0][0].device
        trees_on = _trees_on(params)
        dst = sharding.MeshDevice(-1, home)
        pods, losses = [], []
        for p, row in enumerate(grid):
            total = None
            for d, member in enumerate(row):
                dev = member.device if placed else home
                loss, _, _, grads = _member_grads(
                    loss_fn, trees_on(dev), {k: v.to(dev) for k, v in parts[p * ndata + d].items()})
                if p == 0:
                    losses.append(loss)
                grads = [g.to(home) for g in grads]
                if total is None:
                    total = grads
                else:  # the float32 psum over data, in member order
                    torch._foreach_add_(total, grads)
            torch._foreach_div_(total, float(ndata))  # pmean over data
            pods.append(total)
        del trees_on
        if compress:
            flat = [compressed_psum([pg[i] for pg in pods], dst) / float(npod)
                    for i in range(len(pods[0]))]
        elif npod > 1:
            flat = [sharding.psum([pg[i] for pg in pods], dst) / float(npod)
                    for i in range(len(pods[0]))]
        else:
            flat = pods[0]
        del pods
        params, opt_state, gnorm, lr = _apply_update(params, opt_state, flat, hp, home)
        loss = sharding.psum(losses, dst) / float(ndata)  # pmean over data
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return wrapped


def train_loop(
    mesh,
    cfg: ModelConfig,
    hp: TrainHParams,
    data_iter,
    *,
    steps: int,
    params=None,
    checkpoint_manager=None,
    checkpoint_every: int = 100,
    log_every: int = 10,
):
    """Host-side loop: data → step → metrics → periodic checkpoints.

    ``params`` None draws ``init_params`` from a generator seeded 0 on the
    first member's device.  On a mesh of one member the state is plain
    tensors on its device and the step ``make_train_step``; on more, the
    parameters are placed by ``param_shardings`` and the AdamW state as
    ``jit_train_step`` places it, and the step is ``jit_train_step``'s, as
    the reference's loop.  Resumes from the latest commit of
    ``checkpoint_manager`` (parameters, AdamW state and step; placed again
    on this mesh by ``elastic.reshard_restore``), so a killed run restarts
    from its last commit, on this mesh or another.  Commits hold whole
    host arrays.  Returns ``(params, opt_state, metrics_hist)``; every
    ``log_every`` steps the metrics are read to the host and printed as
    the reference prints them."""
    members = list(mesh.devices.reshape(-1))
    device = members[0].device
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = tf.init_params(gen, cfg, device=device)
    start_step = 0
    if len(members) == 1:
        params = tf.tree_map(lambda t: t.to(device), params)
        opt_state = adamw.init(params)
        if checkpoint_manager is not None:
            restored = checkpoint_manager.restore_latest(params, opt_state, device=device)
            if restored is not None:
                params, opt_state, start_step = restored
    else:
        from repro_torch.train.elastic import reshard_restore

        params = sharding.place(params, sharding.param_shardings(mesh, params))
        opt_state = _placed_adamw_init(params, mesh)
        if checkpoint_manager is not None:
            restored = reshard_restore(checkpoint_manager, params, opt_state, mesh)
            if restored is not None:  # the step places the restored AdamW state
                params, opt_state, start_step = restored

    metrics_hist = []
    batch = next(data_iter)
    if len(members) == 1:
        step_fn = make_train_step(cfg, hp)
    else:
        step_fn = jit_train_step(mesh, cfg, hp, params, opt_state)(batch)
    t0 = time.time()
    for step in range(start_step, steps):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["sec_per_step"] = (time.time() - t0) / log_every
            t0 = time.time()
            metrics_hist.append(m)
            print(
                f"step {m['step']:6d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                f"{m['sec_per_step']:.3f}s/step",
                flush=True,
            )
        if checkpoint_manager is not None and (step + 1) % checkpoint_every == 0:
            checkpoint_manager.save(step + 1, params, opt_state)
        try:
            batch = next(data_iter)
        except StopIteration:
            break
    return params, opt_state, metrics_hist


__all__ = [
    "TrainHParams",
    "jit_train_step",
    "make_loss_fn",
    "make_manual_dp_step",
    "make_train_step",
    "train_loop",
]
