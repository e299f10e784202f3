"""AdamW with decoupled weight decay (port of ``repro.optim.adamw``).

The state is ``AdamWState(step, m, v)``: a 0-d int32 step and float32
moment trees mirroring the parameters.  :func:`update` returns the new
state and parameters, as the reference does, but writes them IN PLACE:
``m``, ``v`` and the parameters (float32 leaves) are updated by
``torch._foreach_*`` ops under ``torch.no_grad()``, and the returned trees
hold the same tensors.  The caller owns them and must not keep an old
state expecting it unchanged.  The learning rate may be a 0-d tensor (the
schedule's) and the bias corrections come from the device-side step, so a
step reads nothing back to the host.  No kernel: plain elementwise ops,
as the reference has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.transformer import _leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init(params: Any) -> AdamWState:
    """A fresh state: step 0 on the parameters' device, zero float32
    moments shaped as the parameters."""
    first = next(_leaves(params))
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


@torch.no_grad()
def update(state: AdamWState, grads: Any, params: Any, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step: ``(new state, new params)`` (see the module
    docstring: both are the caller's tensors, written in place)."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    gs = [g.float() for g in _leaves(grads)]
    ms, vs, ps = list(_leaves(state.m)), list(_leaves(state.v)), list(_leaves(params))
    if not len(gs) == len(ms) == len(vs) == len(ps):
        raise ValueError(f"{len(gs)} gradients, {len(ms)} / {len(vs)} moments, {len(ps)} params")
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)               # m = b1·m + (1-b1)·g
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)       # v = b2·v + (1-b2)·g²
    denom = torch._foreach_div(vs, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)                         # sqrt(v̂) + eps
    delta = torch._foreach_div(ms, c1)
    torch._foreach_div_(delta, denom)                       # m̂ / (sqrt(v̂) + eps)
    del denom
    pf = [p if p.dtype == torch.float32 else p.float() for p in ps]
    torch._foreach_add_(delta, pf, alpha=weight_decay)      # + wd·p
    torch._foreach_mul_(delta, lr)
    for p, f, d in zip(ps, pf, delta):
        if f is p:
            p.sub_(d)
        else:
            p.copy_(f - d)
    state.step.copy_(step)
    return AdamWState(state.step, state.m, state.v), params


__all__ = ["AdamWState", "init", "update"]
