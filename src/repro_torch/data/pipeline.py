"""Streaming chunk sources and the synthetic LM stream (port of
``repro.data.pipeline``).

Anything with a ``chunks() -> Iterator[Table]`` method is a
:class:`ChunkSource` and feeds ``GroupByPlan.stream`` / ``collect``.
:class:`SyntheticLM` makes Zipf-distributed LM batches from numpy's
``default_rng(seed + step)``, so its tokens equal the reference's bit for
bit, and keeps a streaming GROUP BY token_id COUNT(*) of them through the
port's own plan API (the paper's concurrent engine on the LM's data path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Mapping, Protocol, runtime_checkable

import numpy as np
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


@dataclass
class DataState:
    seed: int
    step: int = 0


class SyntheticLM:
    """Zipf-distributed synthetic token stream on ``device`` (``None``: the
    card; raises where there is none).

    Batch ``step`` draws ``(batch, seq + 1)`` tokens from
    ``np.random.default_rng(seed + step)``, as the reference does, and
    yields ``{"tokens", "targets"}`` int32 tensors on the device (plus
    ``frontend_embeds`` / ``encoder_frames`` for vision and enc-dec configs:
    ``0.02 ·`` a normal draw from a ``torch.Generator`` seeded by the step,
    shaped and scaled as the reference's ``jax.random`` draw, with other
    values).

    ``track_stats`` streams each batch's tokens through
    ``GroupByPlan(keys=("token",), aggs=(count,), strategy="concurrent",
    max_groups=stat_groups, saturation="unchecked", raw_keys=True)``.  Token
    ids at or past ``stat_groups // 2`` become ``EMPTY_I32`` (the
    reference's ``0xFFFFFFFF``), which ticketing skips, so the table never
    saturates and unchecked is exact.  On a card the plan takes the CUDA
    route rule (``engine.executors.cuda_route``): one ``scan_ticket`` and
    one segment-kernel launch a batch, and no host read."""

    def __init__(self, cfg, batch: int, seq: int, *, zipf_a: float = 1.2, seed: int = 0,
                 track_stats: bool = True, stat_groups: int = 4096, device=None):
        from repro_torch.engine.groupby import resolve_device

        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.zipf_a = zipf_a
        self.state = DataState(seed=seed)
        self.track_stats = track_stats
        self.stat_groups = stat_groups
        self.device = resolve_device(None if device is None else str(device))
        if track_stats:
            from repro_torch.engine.executors import cuda_route, make_executor
            from repro_torch.engine.plan_api import AggSpec, ExecutionPolicy, GroupByPlan

            plan = GroupByPlan(
                keys=("token",), aggs=(AggSpec("count"),), strategy="concurrent",
                max_groups=stat_groups, saturation="unchecked", raw_keys=True,
                execution=ExecutionPolicy(device=str(self.device)),
            )
            self._stats = make_executor(cuda_route(plan, plan))
            self._stats.open()

    def _sample(self, rng: np.random.Generator) -> np.ndarray:
        z = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1)).astype(np.int64)
        toks = (z - 1) % self.cfg.vocab_size
        return toks.astype(np.int32)

    def _next_tokens(self) -> torch.Tensor:
        rng = np.random.default_rng(self.state.seed + self.state.step)
        toks = self._sample(rng)
        self.state.step += 1
        return torch.from_numpy(toks).to(self.device)

    def token_stats(self):
        """``(token ids uint32, counts float32)`` numpy arrays of the tokens
        tracked so far (finalize reads the executor's state; iteration can
        go on afterwards)."""
        if not self.track_stats:
            return np.zeros((0,), np.uint32), np.zeros((0,), np.float32)
        out = self._stats.finalize()
        n = int(out["__num_groups__"][0])
        keys = out["key"][:n].cpu().numpy().astype(np.uint32)
        return keys, out["count(*)"][:n].cpu().numpy()

    def _token_table(self, toks: torch.Tensor):
        """One batch's input tokens as a ``Table`` chunk of int32 bit
        patterns, ids past the tracked space ``EMPTY_I32``."""
        from repro_torch.core.hashing import EMPTY_I32
        from repro_torch.engine.columns import Table

        keys = toks[:, :-1].reshape(-1)
        keys = torch.where(keys < self.stat_groups // 2, keys, torch.full_like(keys, EMPTY_I32))
        return Table({"token": keys})

    def chunks(self) -> Iterator[Table]:
        """:class:`ChunkSource` adapter: an unbounded stream of token-key
        tables, one per generated batch.  Pulling a chunk advances the same
        ``DataState`` as ``__iter__``."""
        while True:
            yield self._token_table(self._next_tokens())

    def __iter__(self) -> Iterator[dict]:
        while True:
            toks = self._next_tokens()
            batch = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
            d = self.cfg.d_model
            extras = {}
            if self.cfg.frontend == "vision":
                extras["frontend_embeds"] = (self.batch, self.cfg.frontend_tokens, d)
            if self.cfg.encoder_layers:
                extras["encoder_frames"] = (self.batch, self.seq, d)
            for name, shape in extras.items():
                gen = torch.Generator(device=self.device).manual_seed(self.state.step)
                batch[name] = 0.02 * torch.randn(shape, generator=gen, device=self.device)
            if self.track_stats:
                # unchecked: dispatched without a host read; the card folds
                # this batch's counts while the host samples the next one
                self._stats.consume(self._token_table(toks))
            yield batch
