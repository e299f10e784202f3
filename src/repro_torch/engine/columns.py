"""Columnar data for the morsel-driven engine (paper §2.1).

A ``Table`` is a dict of equal-length 1-D tensors.  Grouping keys of any
width are canonicalized to ONE key column of int32 bit patterns of the
uint32 hash-key space (``combine_keys``), with ``EMPTY_I32`` (-1, the bit
pattern of ``0xFFFFFFFF``) reserved as the sentinel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.hashing import EMPTY_I32, EMPTY_KEY, murmur3_fmix32, to_i32_bits

_MASK = 0xFFFFFFFF


@dataclass
class Table:
    columns: dict[str, torch.Tensor]

    def __post_init__(self):
        lens = {v.shape[0] for v in self.columns.values()}
        if len(lens) != 1:
            raise ValueError(
                f"ragged columns: { {k: tuple(v.shape) for k, v in self.columns.items()} }"
            )

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def select(self, *names: str) -> "Table":
        return Table({n: self.columns[n] for n in names})


def chunk_key_column(chunk: Table, key_columns, raw_keys: bool = False):
    """Canonicalize one pipeline chunk: the int32 grouping-key column
    (hash-combined unless ``raw_keys``, with the ``__mask__`` selection
    vector applied as the EMPTY sentinel) plus the remaining columns."""
    cols = dict(chunk.columns)
    mask = cols.pop("__mask__", None)
    if raw_keys:
        if len(key_columns) != 1:
            raise ValueError("raw_keys needs exactly one key column")
        keys = to_i32_bits(cols[key_columns[0]])
    else:
        keys = combine_keys(*(cols[c] for c in key_columns))
    if mask is not None:
        keys = torch.where(mask.reshape(-1).to(torch.bool), keys,
                           torch.full_like(keys, EMPTY_I32))
    return keys, cols


def combine_keys(*cols: torch.Tensor) -> torch.Tensor:
    """Hash-combine key columns into one int32 bit-pattern key column,
    bit for bit with ``repro.engine.columns.combine_keys``: a Boost-style
    hash_combine chain over murmur-mixed columns, computed in int64 masked
    to 32 bits; ``EMPTY_KEY`` remaps to ``0x7FFFFFFF``."""
    acc = torch.zeros(cols[0].reshape(-1).shape, dtype=torch.int64,
                      device=cols[0].device)
    for c in cols:
        h = murmur3_fmix32(c.reshape(-1))
        mixed = (h + 0x9E3779B9 + ((acc << 6) & _MASK) + (acc >> 2)) & _MASK
        acc = acc ^ mixed
    acc = torch.where(acc == EMPTY_KEY, torch.full_like(acc, 0x7FFFFFFF), acc)
    return to_i32_bits(acc)
