"""Peaks of the cards the benchmark knows, and the least bytes a query needs.

Peaks are NVIDIA's data-sheet figures at the full power limit (H100 SXM:
3.35 TB/s of HBM3, 80 GB).  ``query_bytes`` counts each input column the
query reads, read once at its own width, and each group's key and each
aggregate's value, written once as 4-byte words: what any route has to
move, whatever it reads again.  It takes the cell's shapes and the
reference's group count only, so it is the same for every route and kernel.
"""
from __future__ import annotations

# torch.cuda.get_device_name() → HBM bytes/s
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device_name: str) -> float | None:
    return HBM_BYTES_PER_S.get(device_name)


def query_bytes(rows: int, row_bytes: int, groups: int, aggregates: int,
                word: int = 4) -> int:
    """Least bytes of one GROUP BY: ``rows`` × ``row_bytes`` (the widths of
    the columns read) in, ``groups`` × (key + ``aggregates``) words out."""
    return rows * row_bytes + word * groups * (1 + aggregates)
