"""Worker-failure bookkeeping: the device-free part of
``repro.train.elastic``.

``mark_failed`` records device ids as lost; the serving layer
(``serve/query_server.py``) lets a quantum that raises
:class:`WorkerFailure` restore from its stream's last checkpoint
(``engine/elastic.py``), or propagate when there is none.  Building the
survivor mesh and resharding a checkpoint onto it (``available_devices``,
``largest_mesh``, ``remesh``, ``reshard_restore``) come with the sharded
stream (ROADMAP.md item 9).
"""
from __future__ import annotations

from dataclasses import dataclass

_failed: set[int] = set()


@dataclass
class WorkerFailure(Exception):
    device_ids: list


def mark_failed(device_ids) -> None:
    _failed.update(device_ids)


def reset_failures() -> None:
    _failed.clear()


def failed_ids() -> frozenset:
    """The device ids currently marked failed."""
    return frozenset(_failed)


__all__ = ["WorkerFailure", "failed_ids", "mark_failed", "reset_failures"]
