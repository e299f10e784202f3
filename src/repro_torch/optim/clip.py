"""Global-norm gradient clipping over a parameter tree, in float32 (port
of ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.models.transformer import _leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in float32: a 0-d tensor on the leaves'
    device."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in _leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)``; each
    leaf keeps its dtype.  New tensors: the caller's gradients are not
    written."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


__all__ = ["clip_by_global_norm", "global_norm"]
