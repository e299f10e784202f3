"""Meta-tensor input stand-ins for every (arch × shape × mode) cell (port
of ``repro.launch.specs``).

Each function returns tensors on the ``meta`` device (shapes and dtypes,
no storage: nothing is allocated) and specs in the port's form, the tuple
of a ``PartitionSpec``'s entries (``parallel/sharding.py``), entry for
entry the reference's.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import _map_with_path, cache_specs, dp_axes

META = torch.device("meta")


def _dp_size(mesh) -> int:
    size = 1
    for a in dp_axes(mesh):
        size *= mesh.shape[a]
    return size


def abstract_params(cfg: ModelConfig):
    """``init_params`` on the ``meta`` device: the parameter tree's shapes
    and dtypes, nothing drawn (``models/layers.py`` ``randn``)."""
    return tf.init_params(torch.Generator(), cfg, device=META)


def abstract_opt(params):
    """``adamw.init`` of a meta parameter tree."""
    return adamw.init(params)


def batch_sds(cfg: ModelConfig, cell: ShapeCell, mesh):
    """Training/prefill batch stand-ins + specs."""
    b, s = cell.global_batch, cell.seq_len
    dp = dp_axes(mesh)
    split = b % _dp_size(mesh) == 0
    bspec = (dp, None) if split else (None, None)
    args: dict[str, Any] = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    specs: dict[str, Any] = {"tokens": bspec}
    if cell.mode == "train":
        args["targets"] = torch.empty((b, s), dtype=torch.int32, device=META)
        specs["targets"] = bspec
    if cfg.frontend == "vision":
        args["frontend_embeds"] = torch.empty((b, cfg.frontend_tokens, cfg.d_model),
                                              dtype=torch.float32, device=META)
        specs["frontend_embeds"] = (dp, None, None) if split else (None, None, None)
    if cfg.encoder_layers:
        args["encoder_frames"] = torch.empty((b, s, cfg.d_model), dtype=torch.float32,
                                             device=META)
        specs["encoder_frames"] = (dp, None, None) if split else (None, None, None)
    return args, specs


def cache_sds(cfg: ModelConfig, cell: ShapeCell, mesh):
    """Decode caches on ``meta`` + specs + whether they are sequence-sharded.
    Batch-1 long-context cells (a batch the data axes do not divide) shard
    the cache sequence across every mesh axis (sequence-parallel decode):
    k/v (..., B, S, KV, hd) over all axes on S, states of rank >= 4 (...,
    B, H, hd, N) over ``model`` on H, the rest replicated."""
    b = cell.global_batch
    # +512 decode headroom, so the cache sequence dim stays divisible by any
    # shard count used (16 for model-axis, 512 for all-axes sequence-parallel)
    max_len = cell.seq_len + 512
    caches = tf.init_caches(cfg, b, max_len, tf.torch_dtype(cfg.dtype), device=META)
    seq_shard = b % _dp_size(mesh) != 0
    if not seq_shard:
        return caches, cache_specs(mesh, cfg, caches), seq_shard
    all_axes = tuple(mesh.axis_names)

    def spec(path, leaf):
        nd = leaf.dim()
        if path.split("/")[-1] in ("k", "v"):
            return (None,) * (nd - 3) + (all_axes, None, None)
        if "state" in path and nd >= 4:
            return (None,) * (nd - 3) + ("model", None, None)
        return ()

    return caches, _map_with_path(spec, caches), seq_shard


def decode_tokens_sds(cell: ShapeCell, mesh, seq_shard: bool):
    b = cell.global_batch
    spec = (None, None) if seq_shard else (dp_axes(mesh), None)
    return torch.empty((b, 1), dtype=torch.int32, device=META), spec


__all__ = ["abstract_opt", "abstract_params", "batch_sds", "cache_sds", "decode_tokens_sds"]
