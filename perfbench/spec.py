"""A cell of ``BENCHMARK.json`` with its configuration, traffic mix, metrics
and limits, each read from the file its name points to."""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is read in ``cell``: listed under its
    ``workloads``, or, without that key, wherever what it moves (an
    end-to-end metric: always) is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple
    limits: dict

    @property
    def rows(self) -> int:
        return int(self.config["rows"])

    @property
    def key(self) -> str:
        return self.traffic["key"]

    @property
    def aggs(self) -> tuple:
        return tuple((kind, col) for kind, col in self.traffic["aggs"])

    @property
    def chunk_rows(self) -> int:
        return int(self.traffic["chunk_rows"])

    @property
    def value_columns(self) -> tuple:
        return tuple(sorted({c for _, c in self.aggs if c is not None}))

    @property
    def columns(self) -> dict:
        """Every column of the configuration, resident whatever the query
        reads: the configuration's entry of each, updated by the traffic
        mix's."""
        mix = self.traffic.get("columns", {})
        return {c: {**spec, **mix.get(c, {})} for c, spec in self.config["columns"].items()}

    def resized(self, rows: int, **columns) -> "Cell":
        """The same cell at ``rows`` rows, with column entries updated (for
        tests at a size a CPU holds)."""
        cols = {c: {**spec, **columns.get(c, {})}
                for c, spec in self.config["columns"].items()}
        return replace(self, config={**self.config, "rows": rows, "columns": cols})


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    # a cell without limits yet is compared against none: never correct
    limits = root / "perfbench" / "limits" / f"{name}.json"
    e2e = tuple(m for m in bench["end_to_end"] if applies(m, name, set()))
    reported = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"] if applies(m, name, reported))
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read_json(root / conf["file"]),
        traffic=_read_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=layer,
        limits=_read_json(limits) if limits.is_file() else {},
    )
