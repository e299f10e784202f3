"""Checkpointing: atomic commits, async host offload, restore onto a device or a mesh.

Port of ``repro.checkpoint.manager``; a commit written by either package
reads in the other (the same ``step_{step:08d}`` layout, npz key paths and
``meta.json``).

Fault-tolerance contract:
  * a checkpoint directory is COMMITTED only by an atomic rename of a fully
    written temp dir — a crash mid-save never corrupts the latest commit;
  * ``restore_latest`` resumes from the newest commit (the step counter is
    part of the state);
  * leaves are saved as full host arrays (a placed leaf, a
    ``parallel.sharding.PlacedTensor``, gathered whole) and restored onto
    the device the caller names (``device=``) or placed by the shardings
    the caller names (the reference's ``shardings=``): a commit restores
    onto another mesh than the one that saved it (a sharded stream's
    carry restores through ``engine/elastic.py``, onto any member count);
  * saving runs on a background thread (async, off the critical path) with
    a barrier before the next save (at most one in flight).  The leaves are
    copied to host BEFORE ``save`` returns: the port updates tensors in
    place, so a later in-place update never reaches a pending commit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def host_copy(x) -> np.ndarray:
    """A host numpy copy of a leaf, never a view of live state (a CPU
    tensor's ``numpy()`` shares its memory); a placed leaf whole."""
    from repro_torch.parallel.sharding import PlacedTensor

    if isinstance(x, PlacedTensor):
        return x.full("cpu").numpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.numpy().copy() if x.device.type == "cpu" else x.cpu().numpy()
    return np.array(x, copy=True)


def _item_keys(seq) -> list:
    """Path keys of a sequence's items, as ``jax.tree_util`` names them: a
    NamedTuple's fields as ``.<field>`` (``GetAttrKey``), so that an
    ``AdamWState`` saves as ``.step``, ``.m/...`` and ``.v/...``; a plain
    tuple's or list's items by index."""
    fields = getattr(seq, "_fields", None)
    return ["." + f for f in fields] if fields is not None else [str(i) for i in range(len(seq))]


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs in the order of ``jax.tree_util``'s
    ``tree_flatten_with_path``: dict keys sorted, sequence items in order
    (:func:`_item_keys`), ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for key, v in zip(_item_keys(tree), tree):
            yield from _leaves(v, prefix + (key,))
    else:
        yield "/".join(prefix), tree


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: host_copy(leaf) for key, leaf in _leaves(tree)}


def _unflatten_into(tree_template, flat: dict[str, np.ndarray], device=None, prefix=()):
    """The template's structure with each leaf read from ``flat`` under its
    key path: tensors for tensor and placed leaves (on ``device``, else the
    host), numpy arrays for the others."""
    from repro_torch.parallel.sharding import PlacedTensor

    if tree_template is None:
        return None
    if isinstance(tree_template, dict):
        return {k: _unflatten_into(v, flat, device, prefix + (str(k),))
                for k, v in tree_template.items()}
    if isinstance(tree_template, (list, tuple)):
        items = [_unflatten_into(v, flat, device, prefix + (key,))
                 for key, v in zip(_item_keys(tree_template), tree_template)]
        if isinstance(tree_template, list):
            return items
        return (type(tree_template)(*items) if hasattr(tree_template, "_fields")
                else tuple(items))
    key = "/".join(prefix)
    arr = flat[key]
    shape = tuple(tree_template.shape) if hasattr(tree_template, "shape") else ()
    assert arr.shape == shape, f"{key}: ckpt {arr.shape} vs model {shape}"
    if isinstance(tree_template, (torch.Tensor, PlacedTensor)):
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
        return t.to(device) if device is not None else t
    return arr


# -- the atomic-commit contract (shared) -------------------------------------
#
# Both the CheckpointManager and the engine's elastic stream checkpoints
# (engine/elastic.py) commit through these functions, so the crash-safety
# argument lives exactly once: a commit directory exists iff its every file
# was fully written (write to a temp dir, then one atomic rename).  Stale
# ``.tmp_step_*`` leftovers from a crashed save are invisible to
# ``latest_commit`` and overwritten by the next save of the same step.


def commit_payload(directory: str, step: int,
                   payload: dict[str, dict[str, np.ndarray]],
                   meta: dict) -> str:
    """Atomically commit ``{name: flat-array-dict}`` npz files plus a
    ``meta.json`` as ``step_{step:08d}`` under ``directory``; returns the
    committed path.  Re-committing an existing step replaces it (the old
    commit is removed first, as a rename over a populated dir fails on some
    platforms; the temp dir still guarantees no torn state)."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name, flat in payload.items():
        np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_commit_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    commits = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return int(commits[-1].split("_")[1]) if commits else None


def latest_commit(directory: str, names: tuple = ("state",)):
    """Newest commit under ``directory`` as ``(step, {name: arrays}, meta)``,
    or ``None`` when nothing has been committed (in-flight ``.tmp_step_*``
    dirs never count)."""
    step = latest_commit_step(directory)
    if step is None:
        return None
    path = os.path.join(directory, f"step_{step:08d}")
    payload = {
        name: dict(np.load(os.path.join(path, f"{name}.npz")))
        for name in names
    }
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return step, payload, meta


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, params, opt_state=None, extra: dict | None = None):
        if self._thread is not None:
            self._thread.join()  # at most one async save in flight
        # snapshot to host BEFORE returning control (in-place update safety)
        payload = {"params": _flatten(params)}
        if opt_state is not None:
            payload["opt"] = _flatten(opt_state)
        meta = {"step": step, "time": time.time(), **(extra or {})}

        def _write():
            commit_payload(self.dir, step, payload, meta)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        commits = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in commits[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> int | None:
        return latest_commit_step(self.dir)

    def restore_latest(self, params_template, opt_template=None, *, device=None,
                       shardings=None):
        """``(params[, opt], step)`` from the newest commit, each leaf
        shaped as the template's and put on ``device`` (host tensors when
        None), or ``None`` when nothing has been committed.  ``shardings``
        (a tree of ``parallel.sharding.NamedSharding``, as the reference's)
        places the parameters by it instead; the optimizer state then
        comes back as host tensors, as the reference's does.  The two are
        exclusive."""
        if device is not None and shardings is not None:
            raise ValueError("restore_latest takes device= or shardings=, not both")
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step:08d}")
        pflat = dict(np.load(os.path.join(path, "params.npz")))
        params = _unflatten_into(params_template, pflat, device)
        if shardings is not None:
            from repro_torch.parallel.sharding import place

            params = place(params, shardings)
        out = [params]
        if opt_template is not None:
            oflat = dict(np.load(os.path.join(path, "opt.npz")))
            out.append(_unflatten_into(opt_template, oflat, device))
        out.append(step)
        return tuple(out)


__all__ = [
    "CheckpointManager",
    "commit_payload",
    "host_copy",
    "latest_commit",
    "latest_commit_step",
]
