"""Int8 block quantization for gradient all-reduce (port of
``repro.optim.compression``): values are scaled per block of
:data:`BLOCK` to int8.  :func:`compressed_psum` is the all-reduce over the
members of a mesh axis that ``train.loop.make_manual_dp_step`` runs over
the pod axis under ``grad_compression="int8"``: each member quantizes its
own tensor, the int8 blocks travel and are summed in int32, the scales are
summed, and the sum is dequantized with the mean scale."""
from __future__ import annotations

from typing import Sequence

import torch

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    flat = x.reshape(-1)
    rem = (-n) % BLOCK
    if rem:
        flat = torch.cat([flat, torch.zeros((rem,), dtype=x.dtype, device=x.device)])
    return flat, n


def quantize(x: torch.Tensor):
    """``(q (n_blocks, BLOCK) int8, scale (n_blocks, 1) float32, n)``."""
    flat, n = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float(), n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int, shape, dtype) -> torch.Tensor:
    blocks = q.float() * scale
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def compressed_psum(tensors: Sequence[torch.Tensor], dst) -> torch.Tensor:
    """All-reduce of the members' tensors (member i's on its own device) in
    int8 blocks, on ``dst`` (a ``parallel.sharding.MeshDevice``), as the
    mesh's ``psum`` takes them: the reference's ``compressed_psum(x,
    axis)`` inside ``shard_map``, whose participants are the members.  Each
    member's ``quantize``; the q's summed in int32 and the scales in
    float32 on ``dst``; ``dequantize`` with the mean scale, to the first
    tensor's shape and dtype.  Each member's codes are dequantized with the
    mean of the members' block scales, not their own: near the plain sum
    where the members' scales are alike (the reference's premise for
    gradient shards), biased where they are not."""
    if not tensors:
        raise ValueError("compressed_psum needs at least one member's tensor")
    x = tensors[0]
    qsum = ssum = None
    for t in tensors:
        q, scale, n = quantize(t)           # on the member's device
        q, scale = q.to(dst.device), scale.to(dst.device)  # int8 blocks travel
        qsum = q.to(torch.int32) if qsum is None else qsum.add_(q)
        ssum = scale.clone() if ssum is None else ssum.add_(scale)
    return dequantize(qsum, ssum / float(len(tensors)), n, x.shape, x.dtype)


__all__ = ["BLOCK", "compressed_psum", "dequantize", "quantize"]
