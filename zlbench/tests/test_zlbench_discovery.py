"""Every piece of a cell is found by its name: configurations, traffic
mixes, metric readers; a new mix is a new file and an entry."""

import json

import pytest

from zlbench import spec
from zlbench.tests.tiny import run_tiny

BENCH = spec.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_pieces_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert "loop_voices" in cell.traffic
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(spec.reader(name))


def test_config_files_hold_what_the_entries_say():
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_a_new_mix_is_a_file_and_an_entry():
    """A throwaway mix, written beside the others and named by a new
    workload entry, runs with no other change."""
    path = spec.HERE / "traffic" / "throwaway-mix-test.json"
    path.write_text(json.dumps({"loop_voices": 8, "notes": {
        "rate_hz": 30, "pitch": [40, 80], "velocity": [60, 100],
        "gate_ms": [50, 100]}}))
    try:
        bench = json.loads(json.dumps(BENCH))
        bench["workloads"].append({
            "name": "throwaway", "config": "sketchpad-live-b128",
            "traffic": "throwaway-mix-test", "chips": 1, "why": "a test"})
        cell = spec.load_cell("throwaway", bench)
        assert cell.traffic["loop_voices"] == 8
        line, checks, _ = run_tiny("throwaway", seconds=0.3, bench=bench)
        assert line["correct"], checks
    finally:
        path.unlink()
