"""Int8 block quantization for gradient all-reduce (port of
``repro.optim.compression``): values are scaled per block of
:data:`BLOCK` to int8.  :func:`compressed_psum`, the all-reduce over a mesh
axis, needs the data-parallel step of item 10c and raises until then."""
from __future__ import annotations

import torch

BLOCK = 256

MANUAL_DP_SLICE = ("compressed_psum (the int8 all-reduce of make_manual_dp_step) needs the "
                   "LM placement slice, ROADMAP item 10c")


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


def compressed_psum(x: torch.Tensor, axis: str):
    raise NotImplementedError(MANUAL_DP_SLICE)


__all__ = ["BLOCK", "compressed_psum", "dequantize", "quantize"]
