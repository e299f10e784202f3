"""Optimizer, clipping, schedules and gradient compression (port of
``repro.optim``).  Every function works on the port's parameter trees
(nested dicts of tensors) and keeps its scalars on the device, so a
training step reads nothing back to the host."""
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compression import BLOCK, compressed_psum, dequantize, quantize
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = [
    "AdamWState",
    "BLOCK",
    "adamw",
    "clip_by_global_norm",
    "compressed_psum",
    "constant",
    "dequantize",
    "global_norm",
    "quantize",
    "warmup_cosine",
]
