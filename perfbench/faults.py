"""Faults planted under the timed path, for the test that the comparison
refuses them (and for reading them at a cell's size on the card).

Each is a context manager that patches ``repro_torch`` while it is open:

- ``unchanged``: every second update of an operator returns its state
  unchanged (those launches' committed rows never reach the accumulators);
- ``half_batch``: each chunk reaches the program with half of its rows,
  so counts, sums and means are taken over the rest;
- ``altered``: the first group's first aggregate is altered where the
  result is built.

One chip carries no exchange between chips, so that fault has no cell.
"""
from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged():
    from repro_torch.engine.groupby import GroupByOperator

    real = GroupByOperator.update_planes

    def update_planes(self, tickets, vm):
        self._pb_updates = getattr(self, "_pb_updates", 0) + 1
        if self._pb_updates % 2:
            real(self, tickets, vm)

    with _patched(GroupByOperator, "update_planes", update_planes):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.engine.columns import Table

    executors = importlib.import_module("repro_torch.engine.executors")
    real = executors._ResolvingExecutor.consume_async

    def consume_async(self, chunk):
        half = chunk.num_rows // 2
        return real(self, Table({c: t[:half] for c, t in chunk.columns.items()}))

    with _patched(executors._ResolvingExecutor, "consume_async", consume_async):
        yield


@contextlib.contextmanager
def altered():
    # the package exports a function named groupby: import the modules
    executors = importlib.import_module("repro_torch.engine.executors")
    groupby = importlib.import_module("repro_torch.engine.groupby")
    real = groupby.build_result_table

    def build_result_table(aggs, *args):
        out = real(aggs, *args)
        out.columns[aggs[0].name][0] += 1.0
        return out

    with _patched(groupby, "build_result_table", build_result_table), \
            _patched(executors, "build_result_table", build_result_table):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
