"""Training step and loop on one mesh member (port of ``repro.train.loop``).

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

``train_loop`` runs on the port's ``parallel.sharding.Mesh`` of ONE member:
data → step → metrics → periodic checkpoints, resuming from the
manager's latest commit.  The reference's pjit step (``jit_train_step``)
places parameters over a mesh by placement rules; it comes with the LM
placement slice (ROADMAP item 10c) and raises until then, as does
``train_loop`` on a mesh of more than one member.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.compression import compressed_psum
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel import sharding

PLACEMENT_SLICE = ("{what} places the LM over a mesh of more than one member: it comes with "
                   "the LM placement slice, ROADMAP item 10c")


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


def jit_train_step(mesh, cfg: ModelConfig, hp: TrainHParams, params, opt_state):
    raise NotImplementedError(PLACEMENT_SLICE.format(what="jit_train_step"))


def _dp_grid(mesh) -> list:
    """The members that compute, one per data-parallel coordinate (index 0
    on every other axis): a list over pods (one pod without a pod axis) of
    lists over ``data``, in member order."""
    dp = sharding.dp_axes(mesh)
    missing = [a for a in dp if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"make_manual_dp_step needs the mesh axes {dp}; {mesh!r} lacks {missing}")
    arr = np.moveaxis(mesh.devices, [mesh.axis_names.index(a) for a in dp], range(len(dp)))
    arr = arr.reshape(*arr.shape[:len(dp)], -1)[..., 0]
    return [list(row) for row in arr.reshape(-1, mesh.shape["data"])]


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
    ``clip_by_global_norm``, ``warmup_cosine`` and ``adamw.update``.

    Every member holds the same parameters, so they stay one copy on the
    device of ``params``: the members share that device (virtual members),
    read that copy, and the update writes it ONCE, in place, as
    ``make_train_step``'s.  A member on another device raises: a copy of
    the parameters on each card, each updated identically, comes with the
    LM placement slice (ROADMAP item 10c).  ``loss`` is the mean over ``data`` of the first pod's
    members: the reference reduces the loss over ``data`` only, and its
    replicated output reads the first member's value."""
    loss_fn = make_loss_fn(cfg, hp)
    dp = sharding.dp_axes(mesh)
    grid = _dp_grid(mesh)
    npod, ndata = len(grid), len(grid[0])
    compress = "pod" in dp and hp.grad_compression == "int8"

    def member_grads(params, batch):
        tree = tf.tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, list(tf._leaves(tree)))
        return loss.detach(), [g.float() for g in grads]

    def wrapped(params, opt_state, batch):
        home = next(iter(tf._leaves(params))).device
        for member in (m for row in grid for m in row):
            dev = member.device
            if dev.type != home.type or dev.index not in (None, home.index):
                raise NotImplementedError(PLACEMENT_SLICE.format(
                    what=f"make_manual_dp_step with a member on {member.device} and the "
                         f"parameters on {home}"))
        dst = sharding.MeshDevice(-1, home)
        n = npod * ndata
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, which do not split over "
                                 f"{n} data-parallel members")
        parts = {k: v.tensor_split(n) for k, v in batch.items()}
        pods, losses = [], []
        for p, row in enumerate(grid):
            total = None
            for d, member in enumerate(row):
                loss, grads = member_grads(params, {k: v[p * ndata + d].to(home)
                                                    for k, v in parts.items()})
                if p == 0:
                    losses.append(loss)
                if total is None:
                    total = grads
                else:  # the float32 psum over data, in member order
                    torch._foreach_add_(total, grads)
            torch._foreach_div_(total, float(ndata))  # pmean over data
            pods.append(total)
        if compress:
            flat = [compressed_psum([pg[i] for pg in pods], dst) / float(npod)
                    for i in range(len(pods[0]))]
        elif npod > 1:
            flat = [sharding.psum([pg[i] for pg in pods], dst) / float(npod)
                    for i in range(len(pods[0]))]
        else:
            flat = pods[0]
        it = iter(flat)
        grads = tf.tree_map(lambda _: next(it), params)
        del pods, flat
        grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
        lr = warmup_cosine(
            opt_state.step, peak_lr=hp.peak_lr, warmup=hp.warmup, total=hp.total_steps
        )
        opt_state, params = adamw.update(
            opt_state, grads, params, lr=lr, weight_decay=hp.weight_decay
        )
        loss = sharding.psum(losses, dst) / float(ndata)  # pmean over data
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return wrapped


def _member_device(mesh) -> torch.device:
    members = list(mesh.devices.reshape(-1))
    if len(members) != 1:
        raise NotImplementedError(
            PLACEMENT_SLICE.format(what=f"train_loop on {len(members)} members"))
    return members[0].device


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
    """Host-side loop on the mesh's one member: data → step → metrics →
    periodic checkpoints.  ``params`` None draws ``init_params`` from a
    generator seeded 0 on the member's device.  Resumes from the latest
    commit of ``checkpoint_manager`` (parameters, AdamW state and step), so
    a killed run restarts from its last commit.  Returns ``(params,
    opt_state, metrics_hist)``; every ``log_every`` steps the metrics are
    read to the host and printed as the reference prints them."""
    device = _member_device(mesh)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = tf.init_params(gen, cfg, device=device)
    else:
        params = tf.tree_map(lambda t: t.to(device), params)
    opt_state = adamw.init(params)
    start_step = 0
    if checkpoint_manager is not None:
        restored = checkpoint_manager.restore_latest(params, opt_state, device=device)
        if restored is not None:
            params, opt_state, start_step = restored

    step_fn = make_train_step(cfg, hp)
    metrics_hist = []
    batch = next(data_iter)
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
