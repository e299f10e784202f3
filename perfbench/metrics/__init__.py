"""Metric readers, one module a metric of ``BENCHMARK.json``, named as it.

Each defines ``read(run: perfbench.record.Run) -> float | None``: the
metric's value in its unit, or None where the run holds nothing to read it
from (the harness then leaves the metric out of the result line).
"""
