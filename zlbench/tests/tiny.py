"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: 32 voices,
four clips of one or two bars, eight set-up blocks. The widths (block
size, rate, tempo, envelope, note distributions) stay the cell's.

KEYS is a mix of live notes over the loops: no committed cell plays notes
yet, and the tests hold the note path to the reference through it."""

from __future__ import annotations

import copy
import time

from zlbench import harness, run, spec


KEYS = {"loop_voices": 20, "notes": {"rate_hz": 20, "pitch": [36, 96],
                                     "velocity": [40, 127],
                                     "gate_ms": [60, 600]}}


def tiny_cell(name: str, bench: dict = None, traffic: dict = None):
    """The cell cut to the tiny size; `traffic` in place of its mix."""
    cell = spec.load_cell(name, bench)
    cfg = copy.deepcopy(cell.config)
    cfg.update(num_voices=32, clips=4, clip_bars=[1, 2], setup_blocks=8)
    traffic = copy.deepcopy(traffic or cell.traffic)
    traffic["loop_voices"] = min(int(traffic["loop_voices"]), 20)
    cell.config, cell.traffic = cfg, traffic
    cell.kinds = spec.event_kinds(traffic, cfg)
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 12345, seconds: float = 0.4,
             traced: bool = False, control: bool = False,
             bench: dict = None, traffic: dict = None):
    """One run of the tiny cell on the CPU: (line, checks, forbidden)."""
    cell = tiny_cell(name, bench, traffic)
    return run.run_cell(cell, seed, seconds, traced, "cpu",
                        time.perf_counter(), harness.process_age_s(),
                        control=control)
