"""Finding a cell's pieces by name: `BENCHMARK.json` at the root of the
checkout, a configuration's file (`configs/<name>.json`, named by the
`configs` entry), a traffic mix (`traffic/<name>.json`) and each metric's
reader (`metrics/<name>.py`, loaded by path, a function `read(run)` that
returns the number or None). A new cell, mix or metric is a new file and an
entry: nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list     # the cell's end-to-end metric entries
    per_layer: list      # the cell's per-layer metric entries

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = bench or load_benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    return Cell(w, config, load_traffic(w["traffic"]),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "zlbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
