"""The reference against a brute-force dict, and the comparison's numbers on
results planted with each kind of error."""
import math
from collections import defaultdict

import pytest
import torch

from perfbench import compare, reference

AGGS = (("count", None), ("sum", "v"), ("mean", "v"), ("max", "v"), ("min", "w"))


def _data(n=5000, seed=3):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(-(2**31), 2**31 - 1, (300,), generator=g, dtype=torch.int64)
    keys = keys[torch.randint(0, 300, (n,), generator=g)].to(torch.int32)
    cols = {"v": torch.rand(n, generator=g) * 100 - 30, "w": torch.randn(n, generator=g)}
    return keys, cols


def test_reference_matches_a_dict():
    keys, cols = _data()
    ref = reference.groupby(keys, cols, AGGS)
    groups = defaultdict(list)
    for i, k in enumerate(keys.tolist()):
        groups[k & 0xFFFFFFFF].append(i)
    assert ref["key"].tolist() == sorted(groups)
    v, w = cols["v"].double().tolist(), cols["w"].double().tolist()
    for j, k in enumerate(ref["key"].tolist()):
        rows = groups[k]
        assert int(ref["count(*)"][j]) == len(rows)
        s = math.fsum(v[i] for i in rows)
        assert float(ref["sum(v)"][j]) == pytest.approx(s, rel=1e-12, abs=1e-9)
        assert float(ref["mean(v)"][j]) == pytest.approx(s / len(rows), rel=1e-12, abs=1e-9)
        assert float(ref["max(v)"][j]) == max(v[i] for i in rows)
        assert float(ref["min(w)"][j]) == min(w[i] for i in rows)
        assert float(ref["abs_sum(v)"][j]) == pytest.approx(math.fsum(abs(v[i]) for i in rows))


def _as_result(ref, perm):
    """The reference in a program's layout: float32 columns, groups in
    another order, padded past the group count."""
    out = {"key": torch.cat([ref["key"][perm], torch.full((7,), 0xFFFFFFFF)])}
    for kind, col in AGGS:
        name = reference.agg_name(kind, col)
        out[name] = torch.cat([ref[name][perm].to(torch.float32), torch.zeros(7)])
    return out


def test_compare_reads_zero_on_the_reference_itself():
    keys, cols = _data()
    ref = reference.groupby(keys, cols, AGGS)
    g = ref["key"].shape[0]
    got = compare.compare(_as_result(ref, torch.randperm(g)), g, ref, AGGS)
    assert got["groups_missing"] == got["groups_extra"] == 0
    assert got["count_err"] == 0 and got["max_err"] == 0
    assert got["rel_err"] < 1e-6


@pytest.mark.parametrize("fault,number", [
    ("drop", "groups_missing"), ("repeat", "groups_extra"), ("foreign", "groups_extra"),
    ("count", "count_err"), ("max", "max_err"), ("sum", "rel_err"), ("nan", "rel_err"),
])
def test_compare_sees_each_error(fault, number):
    keys, cols = _data()
    ref = reference.groupby(keys, cols, AGGS)
    g = ref["key"].shape[0]
    res = _as_result(ref, torch.arange(g))
    n = g
    if fault == "drop":
        n = g - 1
    elif fault == "repeat":
        res["key"][g] = res["key"][0]
        n = g + 1
    elif fault == "foreign":
        res["key"][0] = 12345678901 & 0xFFFFFFFF
    elif fault == "count":
        res["count(*)"][5] += 1
    elif fault == "max":
        res["max(v)"][5] = torch.nextafter(res["max(v)"][5], torch.tensor(1e9))
    elif fault == "sum":
        res["sum(v)"][5] += 0.01 * float(ref["abs_sum(v)"][5])
    elif fault == "nan":
        res["mean(v)"][5] = float("nan")
    got = compare.compare(res, n, ref, AGGS)
    ok, checks = compare.judge(got, {"groups_missing": 0, "groups_extra": 0, "count_err": 0,
                                     "max_err": 0, "rel_err": 1e-4})
    assert not ok and checks[number]["value"] > checks[number]["limit"]


def test_judge_fails_a_number_without_limit():
    ok, checks = compare.judge({"rel_err": 0.0}, {})
    assert not ok and checks["rel_err"]["limit"] is None


def test_numbers_follow_the_aggregates():
    assert compare.numbers_for((("sum", "v1"),)) == ("groups_missing", "groups_extra", "rel_err")
    assert compare.numbers_for(AGGS) == ("groups_missing", "groups_extra", "count_err",
                                         "max_err", "rel_err")
