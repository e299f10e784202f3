"""What a run loads and where it refuses to run, in fresh processes."""
import os
import subprocess
import sys

import torch

from perfbench import harness, reference, roofline
from perfbench.spec import ROOT
from perfbench.test_perfbench_faults import small

ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}

RUN_ON_CPU = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
import perfbench.run
from perfbench import harness
from perfbench.test_perfbench_faults import small
line = harness.run(small("paper41_high.uniform"), 5, 0.0, True, "cpu", time.perf_counter())
assert line["correct"], line
assert "repro_torch" in sys.modules
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = RUN_ON_CPU.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.engine", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core.adaptive", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "paper41_high.uniform",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_query_bytes_are_the_same_for_every_route():
    """The bytes take the cell's shapes and the reference's group count,
    which every route's result agrees with."""
    from repro_torch.engine import AggSpec, ExecutionPolicy, GroupByPlan

    cell = small("paper41_high.uniform")
    cols = harness.make_columns(cell, 9, "cpu")
    ref = reference.groupby(cols[cell.key], cols, cell.aggs)
    aggs = [AggSpec(k, c) for k, c in cell.aggs]
    plans = [GroupByPlan(keys=[cell.key], aggs=aggs, raw_keys=True, **kw) for kw in (
        {"execution": ExecutionPolicy(device="cpu")},
        {"strategy": "concurrent", "max_groups": 4096,
         "execution": ExecutionPolicy(device="cpu", ticketing="sort")},
        {"strategy": "hybrid", "max_groups": 4096,
         "execution": ExecutionPolicy(device="cpu")},
    )]
    counts = {int(p.collect(harness.Program(cell, "cpu").chunks(cols))["__num_groups__"][0])
              for p in plans}
    assert counts == {int(ref["key"].shape[0])}
    want = 4 * (cell.rows * 2 + counts.pop() * (1 + 4))
    assert roofline.query_bytes(cell.rows, harness.row_bytes(cell, cols),
                                int(ref["key"].shape[0]), len(cell.aggs)) == want
    assert torch.unique(cols[cell.key]).numel() == ref["key"].shape[0]


def test_row_bytes_take_each_column_at_its_width():
    cell = small("h2o_G1_1e8_1e2.q5")
    cols = harness.make_columns(cell, 9, "cpu")
    # id6, v1, v2 int32 and v3 float64; the columns q5 does not read count nothing
    assert harness.row_bytes(cell, cols) == 4 + 4 + 4 + 8
