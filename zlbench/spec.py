"""Finding a cell's pieces by name: `BENCHMARK.json` at the root of the
checkout, a configuration's file (`configs/<name>.json`, named by the
`configs` entry), a traffic mix (`traffic/<name>.json`), each metric's
reader (`metrics/<name>.py`, loaded by path, a function `read(run)` that
returns the number or None) and each event kind a mix names
(`events/<key>.py`, loaded by path; see `event_kinds`). A new cell, mix,
metric or event kind is a new file and an entry: nothing here changes."""

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
    kinds: list = dataclasses.field(default_factory=list)  # event_kinds

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
    traffic = load_traffic(w["traffic"])
    return Cell(w, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                event_kinds(traffic, config))


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def event_kinds(traffic: dict, config: dict) -> list:
    """The event kinds a mix names: every key but `loop_voices` whose value
    is not null, in the file's order, as (key, module of `events/<key>.py`,
    the value: the kind's parameters). A kind module gives

    - `plan(params, w) -> harness.Plan`: the window's commands from the
      seed, each with its send block, and the blocks the sink keeps;
    - `send(command, w)`: one command, sent under the runtime's lock right
      before its block (`harness.live`);
    - `read(plan, w)`: once after the window, before the program is torn
      down: what the program recorded of when each command took effect;
    - `events(plan, w)`: the plain reference's events, in the order they
      take effect;

    where `w` is the run's `harness.Window`. A bounce sends nothing in its
    window, so a bounce cell whose mix names a kind is refused."""
    kinds = [(key, _load(HERE / "events" / f"{key}.py", "zlbench_event_"),
              value) for key, value in traffic.items()
             if key != "loop_voices" and value is not None]
    if kinds and config["drive"] != "live":
        raise ValueError(
            f"configuration {config['name']!r} drives a {config['drive']}, "
            f"which sends nothing in its window; its mix may name no event "
            f"kind (it names {[k for k, _, _ in kinds]})")
    return kinds


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    return _load(HERE / "metrics" / f"{metric}.py", "zlbench_metric_").read


def _load(path: Path, prefix: str):
    """The module of the file at `path`, loaded by path."""
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
