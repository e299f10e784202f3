"""The comparison that decides ``correct``: a query's result against the
reference, as a map from key to every aggregate.

Numbers compared (each has a limit of its own per cell, in
``limits/<cell>.json``):

- ``groups_missing``: reference keys the result lacks;
- ``groups_extra``: result rows whose key the reference lacks, or that
  repeat a key;
- ``count_err``: the largest gap of a ``count`` aggregate (exact);
- ``max_err``: the largest gap of a ``max`` / ``min`` aggregate (exact);
- ``rel_err``: the largest gap of a ``sum`` over the group's Σ|v|, or of a
  ``mean`` over its Σ|v| / count.

A NaN where the reference has a number reads as an infinite gap.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import agg_name, unsigned_keys


def numbers_for(aggs) -> tuple:
    """The names of the numbers a query with ``aggs`` is compared by."""
    kinds = {k for k, _ in aggs}
    names = ["groups_missing", "groups_extra"]
    if "count" in kinds:
        names.append("count_err")
    if kinds & {"max", "min"}:
        names.append("max_err")
    if kinds & {"sum", "mean"}:
        names.append("rel_err")
    return tuple(names)


def _gap(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    d = (p.to(torch.float64) - r.to(torch.float64)).abs()
    return torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)


def _worst(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def compare(result: dict, num_groups: int, ref: dict, aggs) -> dict:
    """The numbers of ``numbers_for(aggs)`` for one result: ``result`` maps
    ``"key"`` (uint32 values, any integer dtype) and each aggregate's name to
    a column whose first ``num_groups`` rows are the groups."""
    device = ref["key"].device
    pk = unsigned_keys(result["key"][:num_groups].to(device))
    order = torch.argsort(pk)
    pk = pk[order]
    rk = ref["key"]
    g = rk.shape[0]
    first = torch.ones_like(pk, dtype=torch.bool)
    first[1:] = pk[1:] != pk[:-1]
    if g:
        pos = torch.searchsorted(rk, pk).clamp_(max=g - 1)
        matched = (rk[pos] == pk) & first
    else:
        pos = torch.zeros_like(pk)
        matched = torch.zeros_like(first)
    hits = int(matched.sum())
    out = {"groups_missing": float(g - hits), "groups_extra": float(num_groups - hits)}
    at = pos[matched]
    count = ref["count"][at].to(torch.float64)
    rel = [torch.zeros(0, dtype=torch.float64, device=device)]
    for kind, col in aggs:
        name = agg_name(kind, col)
        p = result[name][:num_groups].to(device)[order][matched]
        r = ref[name][at]
        gap = _gap(p, r)
        if kind == "count":
            out["count_err"] = max(out.get("count_err", 0.0), _worst(gap))
        elif kind in ("max", "min"):
            out["max_err"] = max(out.get("max_err", 0.0), _worst(gap))
        else:
            scale = ref[f"abs_sum({col})"][at]
            if kind == "mean":
                scale = scale / count
            rel.append(gap / scale.clamp_min(torch.finfo(torch.float64).tiny))
    if len(rel) > 1:
        out["rel_err"] = _worst(torch.cat(rel))
    return {k: out[k] for k in numbers_for(aggs)}


def worst(readings) -> dict:
    """Each number's largest reading over several results."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(reading: dict, limits: dict) -> tuple:
    """``(ok, checks)``: every number at or under its limit; ``checks`` maps
    each name to ``{"value", "limit"}``.  A number with no limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in reading.items()}
    ok = bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
