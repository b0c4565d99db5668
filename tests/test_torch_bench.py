"""libzl_tpu_torch.bench against the reference's bench.py, on the CPU.

Small sizes (32-64 voices, 8 clips, a few blocks a cell): the port's
session against the reference's on the same seed, the line's keys, every
cell, the self-budget and its watchdog, and the kernels' bounds.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as ref_bench
from libzl_tpu_torch import bench
from libzl_tpu_torch.utils import roofline

REPO = Path(__file__).resolve().parent.parent
CLIPS = 8
# block and round counts that keep every cell to a second or two
TINY = dict(throughput=(2, 3), live_blocks=20, drain=(4, 2), resident=(2, 3),
            headline_blocks=8, sparse_blocks=8, mesh_blocks=3,
            pump_seconds=0.5)


def reference_line_keys() -> list:
    """The keys of the dict that the reference's bench.py prints
    (_emit_result's `out`), read from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    emit = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "_emit_result")
    out = next(n.value for n in ast.walk(emit)
               if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
               and n.targets[0].id == "out")
    return [k.value for k in out.keys]


def _densest_lane(engine) -> int:
    act = engine.pool.active
    return int(np.bincount(engine.pool.lane[act], minlength=12).max())


@pytest.mark.parametrize("voices,active", [(32, 0), (64, 20)])
def test_build_session_matches_the_reference(monkeypatch, voices, active):
    """The same seed-0 draw: the same clips in the bank, the same notes,
    channels, lanes, clips and volumes in the pool, and the first blocks'
    master within the engine rule (rtol 1e-5, atol 2e-6 a voice in the
    densest lane)."""
    monkeypatch.setattr(ref_bench, "NUM_CLIPS", CLIPS)
    ref = ref_bench.build_session(128, num_voices=voices,
                                  active_voices=active)
    port = bench.build_session(128, num_voices=voices, active_voices=active,
                               device="cpu", num_clips=CLIPS, lookahead=0)
    waves, plan = bench.session_plan(48000, active or voices, CLIPS)
    assert len(waves) == CLIPS and len(plan) == (active or voices)
    for _ in range(4):
        want = np.asarray(ref.process_block().outputs.master)
        got = port.process_block().outputs.master.numpy()
        for name in ("active", "midi_note", "midi_channel", "lane", "gain"):
            np.testing.assert_array_equal(getattr(port.pool, name),
                                          getattr(ref.pool, name), name)
        assert int(port.pool.active.sum()) == (active or voices)
        atol = 2e-6 * max(_densest_lane(port), 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
        assert np.abs(got).max() > 0.01
    used = min(port.bank.data.shape[0], ref.bank.data.shape[0])
    np.testing.assert_array_equal(np.asarray(port.bank.data[:used]),
                                  np.asarray(ref.bank.data[:used]))
    port.drain_speculation()


def test_the_line_has_every_key_of_the_reference():
    keys = reference_line_keys()
    assert "rt_superblock_rounds" in keys and "fence_seconds" in keys
    line = bench.Run("cpu", 60.0).line(partial=False)
    missing = [k for k in keys if k not in line]
    assert not missing, missing
    for extra in ("device", "dispatch_floor_ms", "fetch_kernel_ms",
                  "mixdown_kernel_ms", "kernel_host_ms_p50"):
        assert extra in line, extra
    json.dumps(line)


@pytest.fixture(scope="module")
def tiny_run():
    """Every cell once, at 64 voices and TINY's counts."""
    run = bench.Run("cpu", budget_s=600.0, num_voices=64, num_clips=CLIPS,
                    reserve_s=0.0)
    bench.run_cells(run, TINY)
    return run


@pytest.mark.parametrize("key", ["value", "vs_baseline", "rt_superblock",
                                 "rt_superblock_best", *bench.CELLS])
def test_each_cell_is_finite_and_positive_on_the_cpu(tiny_run, key):
    assert not tiny_run.failed and not tiny_run.skipped, (
        tiny_run.failed, tiny_run.skipped)
    value = tiny_run.line(partial=False)[key]
    assert isinstance(value, float) and math.isfinite(value) and value > 0, (
        key, value)


def test_the_tiny_run_reports_its_device_rounds_and_bounds(tiny_run):
    line = tiny_run.line(partial=False)
    assert line["device"] == "cpu" and "partial" not in line
    # the small pool coalesces some of the 64 commands: count what plays
    active = int(line["metric"].split("_")[2].removesuffix("voices"))
    assert 32 <= active <= 64
    assert line["metric"] == (f"realtime_factor_{active}voices_{CLIPS}"
                              f"clips_48k")
    assert len(line["rt_superblock_rounds"]) == TINY["throughput"][0]
    assert line["value"] == float(np.median(line["rt_superblock_rounds"]))
    assert line["vs_baseline"] == line["value"] * active / 96.0
    # a share of a bound never reads over 100
    assert 0 < line["kernel_pct_of_bound"] <= 100.0
    assert 0 < line["pct_of_bound"] <= 100.0
    assert line["kernel_bound_ms"] <= (line["fetch_kernel_ms"]
                                       + line["mixdown_kernel_ms"])


def test_a_cell_that_raises_stays_at_minus_one(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no such card")

    monkeypatch.setattr(bench, "measure_throughput", boom)
    monkeypatch.setattr(bench, "measure_live_mode", lambda *a, **k: None)
    for name in ("measure_reference_headline", "measure_sparse_session",
                 "measure_mesh_realtime", "measure_pump_share"):
        monkeypatch.setattr(bench, name, lambda *a, **k: 2.0)
    run = bench.Run("cpu", 60.0, num_voices=32, num_clips=CLIPS,
                    reserve_s=0.0)
    bench.run_cells(run, TINY)
    line = run.line(partial=False)
    assert run.failed == ["throughput"]
    assert line["value"] == -1.0 and line["vs_baseline"] == -1.0
    assert line["rt_liveblock"] == -1.0
    assert line["realtime_factor_96voices"] == 2.0


def test_a_spent_budget_skips_every_cell(capsys):
    run = bench.Run("cpu", budget_s=0.0, num_voices=32, num_clips=CLIPS)
    bench.run_cells(run, TINY)
    assert not run.failed and "throughput" in run.skipped
    run.emit(partial=False)
    run.emit(partial=False)            # printed once only
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["partial"] is True and line["device"] == "cpu"
    assert all(line[k] == -1.0 for k in bench.CELLS)


def test_the_watchdog_prints_a_partial_line_and_exits_0():
    """A budget that ends inside the first cell (the full-size session on
    the CPU): one JSON line with "partial": true and -1 cells, exit 0."""
    env = dict(os.environ, LIBZL_BENCH_BUDGET_S=str(
        bench.WATCHDOG_MARGIN_S + 1.0), PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "libzl_tpu_torch.bench", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert len(out) == 1, proc.stdout
    line = json.loads(out[0])
    assert line["partial"] is True
    assert line["value"] == -1.0 and line["rt_liveblock"] == -1.0
    assert "exhausted" in proc.stderr


def test_main_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    assert bench.main(["--device", "cuda:0"]) == 2


def test_capture_calls_restores_the_wrappers_after_a_failure():
    from libzl_tpu_torch.ops import finish, voice
    from libzl_tpu_torch.parallel import sharding

    def wrappers():
        return (voice.fetch_interp, sharding.lane_mixdown, voice.voice_prep,
                voice.voice_post, finish.finish)

    before = wrappers()

    def fails():
        raise ValueError("mid-render")

    with pytest.raises(ValueError):
        bench.capture_calls(fails)
    assert wrappers() == before
    assert bench.capture_calls(lambda: None) == {
        "fetch": [], "mixdown": [], "voice_prep": [], "voice_post": [],
        "finish": []}


def test_mixdown_bound_counts_each_byte_once():
    contrib = torch.zeros(3, 40, 16, 2)
    lane = torch.arange(40, dtype=torch.int32) % 14    # 12, 13: no lane
    out_bytes = 3 * 12 * 16 * 2 * 4
    b = roofline.mixdown_bound(contrib, lane)
    assert b["bytes"] == contrib.numel() * 4 + 40 * 4 + out_bytes
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bytes"] / roofline.HBM_BYTES_PER_S * 1e3
    with_init = roofline.mixdown_bound(contrib, lane,
                                       torch.zeros(3, 12, 16, 2))
    assert with_init["bytes"] == b["bytes"] + out_bytes


def test_fetch_bound_counts_unique_taps_of_valid_frames():
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    V, B, n = 4, 128, 1 << 16
    region = region_rows(B)
    sound = torch.zeros(2, n)
    pos = torch.arange(B, dtype=torch.int32).repeat(V, 1)
    pos[3] = -1                                        # an idle voice
    win = torch.zeros(V, dtype=torch.int32)
    b = roofline.fetch_bound((sound, pos, torch.zeros(V, B), win, win))
    assert b["valid_frames"] == 3 * B
    assert b["unique_taps"] == B + 1                   # taps 0..B, shared
    assert b["bytes"] == 16 * V * B + 8 * V + (B + 1) * 2 * 4
    assert region > B and b["bound_by"] == "bytes"


@pytest.mark.parametrize("rel", ["libzl_tpu_torch/bench.py",
                                 "libzl_tpu_torch/utils/roofline.py"])
def test_the_bench_imports_only_the_port(rel):
    """Nothing of the reference: not its package, its bench.py or tools/,
    and not chip_smoke.py."""
    tree = ast.parse((REPO / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [m for m in names if m.split(".")[0] in (
        "libzl_tpu", "jax", "jaxlib", "bench", "tools", "chip_smoke")]
    assert not bad, bad
