"""The benchmark's live re-stretch cell (`live-restretch-b256`: the
`restretch` event kind over the 256-frame live sketchpad) cut to the tiny
size and run on the CPU through the port: knob turns sent as the C API
sends them, re-rendered on the render worker, swapped in where the engine
records, and held to the plain reference, which reloads each clip at the
recorded block with its own WSOLA render.

The run is `correct` on the horizon path (lookahead "auto", H=8 on the CPU
at 256 frames) and on the card's per-block path; with the reference told a
block late or early it is not, nor is the bfloat16 control; a program
that keeps no record of its re-renders, or renders with another stretcher
than the configuration's, fails in the kind's plan, before the window.
"""

import time
import types

import pytest

from zlbench import harness, reference, run
from zlbench.tests.tiny import tiny_cell

CELL = "live-restretch-b256"
SEED = 2 ** 31 + 2424
SECONDS = 2.4
# three turns of three steps in 2.4 s, each kept for 0.8 s after its send
TRAFFIC = {"loop_voices": 20, "notes": None,
           "restretch": {"bursts": 3, "first_s": 0.1, "every_s": 0.5,
                         "jitter_s": 0.1, "steps": 3, "step_ms": 60,
                         "keep_s": 0.8,
                         "pitch": {"step": 1, "range": [-12, 12]},
                         "speed": {"step": 0.05, "range": [0.8, 1.25]}}}


def _cell(lookahead=None, late: int = 0):
    cell = tiny_cell(CELL, traffic=TRAFFIC)
    if lookahead is not None:
        cell.config["runtime"] = dict(cell.config["runtime"],
                                      lookahead=lookahead)
    if late:
        (key, mod, params), = cell.kinds
        told = types.SimpleNamespace(
            plan=mod.plan, send=mod.send, read=mod.read,
            events=lambda plan, w: [
                reference.Reload(e.block + late, e.clip, e.audio)
                for e in mod.events(plan, w)])
        cell.kinds = [(key, told, params)]
    return cell


def _run(cell, control: bool = False):
    seen = {}
    read = harness.read_events

    def spy(plans, w):
        read(plans, w)
        seen["plans"] = plans
    harness.read_events = spy
    try:
        line, checks, _ = run.run_cell(cell, SEED, SECONDS, False, "cpu",
                                       time.perf_counter(),
                                       harness.process_age_s(),
                                       control=control)
    finally:
        harness.read_events = read
    (_, plan), = seen["plans"]
    return line, checks, plan


@pytest.fixture(scope="module")
def per_block():
    """One per-block run, with the bfloat16 control read beside it."""
    return _run(_cell(lookahead=0), control=True)


def test_per_block_path_is_correct(per_block):
    line, checks, plan = per_block
    assert checks["master_gap"]["value"] <= checks["master_gap"]["limit"]
    assert checks["blocks_missing"]["value"] == 0
    assert line["failed"] == 0
    assert len(plan.commands) == 9
    # the renders were applied in the window, after their sends
    applied = plan.state["applied"]
    assert len(applied) >= 3
    assert all(at in plan.keep for at, _ in applied)


def test_control_is_not_correct(per_block):
    _, checks, _ = per_block
    c = checks["control_gap"]
    assert c["value"] > c["limit"], c


def test_horizon_path_is_correct():
    line, checks, plan = _run(_cell())
    assert line["correct"], checks
    assert plan.state["applied"]


@pytest.mark.parametrize("late", [1, -1], ids=["late", "early"])
def test_told_one_block_off_is_not_correct(late):
    line, checks, _ = _run(_cell(lookahead=0, late=late))
    assert not line["correct"], checks


def test_a_program_with_no_record_fails_before_the_window(monkeypatch):
    from libzl_tpu_torch.engine.engine import AudioEngine

    init = AudioEngine.__init__

    def parent_style(self, *a, **kw):
        init(self, *a, **kw)
        del self.applied_renders
    monkeypatch.setattr(AudioEngine, "__init__", parent_style)

    def no_window(*a, **kw):
        raise AssertionError("the window started")
    monkeypatch.setattr(harness, "live", no_window)
    with pytest.raises(RuntimeError, match="keeps no record"):
        _run(_cell(lookahead=0))


def test_another_stretcher_fails_before_the_window(monkeypatch):
    cell = _cell(lookahead=0)
    cell.config["stretch"] = "vocoder"
    monkeypatch.setattr(harness, "live", lambda *a, **kw: pytest.fail(
        "the window started"))
    with pytest.raises(RuntimeError, match="stretch backend"):
        _run(cell)
