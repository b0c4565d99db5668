"""live-seq-b256 at its tiny size on the CPU on the card's path, the
per-block engine (lookahead 0: a card's "auto" at 256 frames, where the
CPU's gives H=8): the port against the plain reference, and the faults of
the played notes' path, each of which must come out not correct."""

import time

import pytest

from zlbench import harness, run
from zlbench.tests.test_zlbench_correct import _half_voices, _late_notes
from zlbench.tests.tiny import tiny_cell

CELL = "live-seq-b256"
SEED = 2 ** 32 + 4321


def _run_card_path(seconds: float, seed: int = SEED):
    cell = tiny_cell(CELL)
    cell.config["runtime"] = dict(cell.config["runtime"], lookahead=0)
    return run.run_cell(cell, seed, seconds, False, "cpu",
                        time.perf_counter(), harness.process_age_s())


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 99])
def test_per_block_path_matches_reference(seed):
    line, checks, forbidden = _run_card_path(0.5, seed)
    assert line["correct"], checks
    assert line["attempted"] > 0 and line["failed"] == 0
    assert not forbidden


@pytest.mark.parametrize("fault", [_half_voices, _late_notes],
                         ids=["half_voices", "late_notes"])
def test_broken_note_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line, checks, _ = _run_card_path(0.6)
    assert not line["correct"], checks
