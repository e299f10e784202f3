"""Morsel management (paper §2.1, Leis et al.).

Splits a column stream into fixed-size morsels, padding the tail with the
EMPTY sentinel, the unit of vectorized execution in the engine and of the
fused kernel's per-program loop.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.hashing import EMPTY_I32

DEFAULT_MORSEL_ROWS = 4096


def morselize_chunk(
    keys: torch.Tensor, values: Mapping[str, torch.Tensor], morsel_rows: int
):
    """Pad an int32 key column (EMPTY sentinel) and its value columns
    (zeros) to a morsel multiple and stack them as
    ``(num_morsels, morsel_rows)``.  Returns ``(km, vm, num_morsels)``."""
    n = keys.shape[0]
    rem = (-n) % morsel_rows
    if rem:
        keys = torch.cat([keys, keys.new_full((rem,), EMPTY_I32)])
    num = keys.shape[0] // morsel_rows
    km = keys.reshape(num, morsel_rows)
    vm = {}
    for col, v in values.items():
        v = v.reshape(-1).to(torch.float32)
        if rem:
            v = torch.cat([v, v.new_zeros((rem,))])
        vm[col] = v.reshape(num, morsel_rows)
    return km, vm, num
