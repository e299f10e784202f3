"""The plain reference: GROUP BY over the raw columns in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the columns the benchmark generated and gives, per distinct key in
ascending order, every aggregate of the query.  ``groupby`` computes in
float64 (counts in int64); ``groupby_control`` is the same computation with
its planes in bfloat16, the precision below the configuration's float32,
which the comparison has to refuse.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def unsigned_keys(keys: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) → uint32 values in int64."""
    return keys.reshape(-1).to(torch.int64) & _M32


def agg_name(kind: str, column: str | None) -> str:
    """The result column of an aggregate: ``count(*)``, ``sum(v)``, ..."""
    return f"{kind}({column or '*'})"


def groupby(keys: torch.Tensor, columns: dict, aggs, dtype=torch.float64) -> dict:
    """``{"key": ascending unique keys (int64), "count": rows a group (int64),
    "abs_sum(<col>)": Σ|v| a group, agg_name: value}`` for each ``(kind,
    column)`` of ``aggs``; sums, means and maxima in ``dtype``.  One value
    column at a time, so at most one column's float64 copy is live."""
    uniq, inv = torch.unique(unsigned_keys(keys), return_inverse=True)
    g = uniq.shape[0]
    count = torch.bincount(inv, minlength=g)
    if dtype != torch.float64:
        # a plane of ones folded in ``dtype``, as the program counts
        plane = torch.zeros(g, dtype=dtype, device=inv.device)
        count_plane = plane.index_add_(0, inv, torch.ones(inv.shape, dtype=dtype,
                                                          device=inv.device))
    else:
        count_plane = count
    out = {"key": uniq, "count": count}
    for col in sorted({c for _, c in aggs if c is not None}):
        v = columns[col].reshape(-1).to(dtype)
        s = torch.zeros(g, dtype=dtype, device=v.device).index_add_(0, inv, v)
        out[f"abs_sum({col})"] = torch.zeros(g, dtype=torch.float64, device=v.device) \
            .index_add_(0, inv, v.abs().to(torch.float64))
        for kind, c in aggs:
            if c != col:
                continue
            if kind == "sum":
                out[agg_name(kind, c)] = s
            elif kind == "mean":
                out[agg_name(kind, c)] = s / count_plane.to(dtype)
            elif kind in ("max", "min"):
                fill = float("-inf") if kind == "max" else float("inf")
                out[agg_name(kind, c)] = torch.full((g,), fill, dtype=dtype, device=v.device) \
                    .scatter_reduce_(0, inv, v, "amax" if kind == "max" else "amin")
            else:
                raise ValueError(f"unknown aggregate {kind!r} over {c!r}")
        del v
    for kind, c in aggs:
        if kind == "count":
            out[agg_name(kind, c)] = count_plane
    return out


def groupby_control(keys: torch.Tensor, columns: dict, aggs) -> dict:
    """The control: the reference with bfloat16 planes (values, sums, counts
    and maxima held in bfloat16), in the program's result layout."""
    ref = groupby(keys, columns, aggs, dtype=torch.bfloat16)
    out = {"key": ref["key"], "__num_groups__": ref["key"].shape[0]}
    for kind, c in aggs:
        out[agg_name(kind, c)] = ref[agg_name(kind, c)].to(torch.float32)
    return out
