"""The comparison fails the control and each planted fault, and passes the
program, through a whole run of each cell at a size a CPU holds (the
program's plain versions; the run past the look for a card)."""
import time
from dataclasses import replace

import pytest

from perfbench import compare, faults, harness, reference
from perfbench.spec import load_benchmark, load_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SMALL = {"paper41_high": (2048, {"k": {"distinct": 204}}),
         "h2o_G1_1e8_1e2": (2048, {"id6": {"high": 20}})}


def small(name):
    cell = load_cell(name)
    rows, cols = SMALL[cell.config["name"]]
    cell = cell.resized(rows, **cols)
    return replace(cell, traffic={**cell.traffic, "chunk_rows": rows // 4})


def run(cell, seed=2**31 + 3):
    return harness.run(cell, seed, 0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_program_passes(name):
    line = run(small(name))
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    # one query and no allocator on the CPU: no percentile and no peak
    assert set(line["metrics"]) == {"rows_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = small(name)
    for seed in (1, 2, 3):
        cols = harness.make_columns(cell, seed, "cpu")
        ref = reference.groupby(cols[cell.key], cols, cell.aggs)
        ctl = reference.groupby_control(cols[cell.key], cols, cell.aggs)
        ok, checks = compare.judge(
            compare.compare(ctl, ctl["__num_groups__"], ref, cell.aggs), cell.limits)
        assert not ok, checks


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault):
    with faults.FAULTS[fault]():
        line = run(small(name))
    assert not line["correct"], line["checks"]
