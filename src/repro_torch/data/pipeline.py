"""Streaming chunk sources for ``GroupByPlan.stream`` / ``collect``.

Port of the source half of ``repro.data.pipeline``: anything with a
``chunks() -> Iterator[Table]`` method is a :class:`ChunkSource`.  The
synthetic LM stream (``SyntheticLM``) comes with the LM stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Mapping, Protocol, runtime_checkable

import torch

if TYPE_CHECKING:  # the engine imports this module (spill readback)
    from repro_torch.engine.columns import Table


@runtime_checkable
class ChunkSource(Protocol):
    """A pull-based producer of ``Table`` chunks; the consumer pulls on
    demand, so sources may be unbounded."""

    def chunks(self) -> Iterator[Table]: ...  # pragma: no cover - protocol


@dataclass
class IterableSource:
    """Any iterable of ``Table`` chunks, or a zero-argument callable that
    returns one (re-streamable)."""

    tables: object

    def chunks(self) -> Iterator[Table]:
        src = self.tables() if callable(self.tables) else self.tables
        yield from src


@dataclass
class ArraySource:
    """Raw columnar tensors cut into ``chunk_rows``-row ``Table`` chunks
    (the last one ragged)."""

    columns: Mapping[str, torch.Tensor]
    chunk_rows: int = 1 << 16

    def chunks(self) -> Iterator[Table]:
        from repro_torch.engine.columns import Table

        n = next(iter(self.columns.values())).shape[0]
        for start in range(0, n, self.chunk_rows):
            end = min(start + self.chunk_rows, n)
            yield Table({k: v[start:end] for k, v in self.columns.items()})


@dataclass
class BlockSource:
    """Host-resident column blocks (``{name: np.ndarray}`` dicts), each one
    ``Table`` chunk, turned into tensors only when the consumer pulls it."""

    blocks: tuple

    def chunks(self) -> Iterator[Table]:
        from repro_torch.engine.columns import Table

        for block in self.blocks:
            yield Table({k: torch.as_tensor(v) for k, v in block.items()})
