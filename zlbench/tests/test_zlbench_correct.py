"""The plain reference against the port at a tiny size on the CPU, the
control (the reference's bank in bfloat16 in the program's place), and
runs with the timed path broken underneath: each must come out not
correct. The harness's look for a card is skipped (run_cell on "cpu")."""

import pytest
import torch

from zlbench import spec
from zlbench.tests.tiny import KEYS, run_tiny

CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])
# each cell, and live notes over the live cell's loops
CASES = [(c, None) for c in CELLS] + [("live-loops", KEYS)]
IDS = [c if t is None else c + "-keys" for c, t in CASES]


@pytest.mark.parametrize("name,traffic", CASES, ids=IDS)
def test_port_matches_reference(name, traffic):
    line, checks, forbidden = run_tiny(name, traffic=traffic)
    assert line["correct"], checks
    assert checks["master_gap"]["value"] < checks["master_gap"]["limit"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert not forbidden
    assert {m for m in line["metrics"]} >= {"setup_s"}


@pytest.mark.parametrize("name,traffic", CASES, ids=IDS)
def test_control_fails(name, traffic):
    """The reference with its bank in bfloat16, read against the float32
    reference over the same blocks, is over the limit."""
    _, checks, _ = run_tiny(name, control=True, traffic=traffic)
    c = checks["control_gap"]
    assert c["value"] > c["limit"], c


def _frozen(monkeypatch):
    """A step that returns its state unchanged: after the set-up, every
    block is the last one again."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    orig = AudioEngine.process_block
    state = {"n": 0, "last": None}

    def process_block(self):
        state["n"] += 1
        if state["n"] <= 10:
            state["last"] = orig(self)
        return state["last"]

    monkeypatch.setattr(AudioEngine, "process_block", process_block)


def _half_voices(monkeypatch):
    """Half of the batch left out: every second start command claims no
    voice."""
    from libzl_tpu_torch.engine.allocator import VoiceAllocator

    orig = VoiceAllocator._start
    state = {"n": 0}

    def _start(self, *a, **k):
        state["n"] += 1
        if state["n"] % 2:
            return orig(self, *a, **k)

    monkeypatch.setattr(VoiceAllocator, "_start", _start)


def _altered(monkeypatch):
    """An answer altered where it is produced: the finish adds 0.01 to
    the first frame of each block's master."""
    from libzl_tpu_torch.ops import finish

    orig = finish.finish

    def altered(lane_mix, strips):
        out = orig(lane_mix, strips)
        dry = out[0].clone()
        dry[:, 0, 0, 0] += 0.01
        return (dry,) + tuple(out[1:])

    monkeypatch.setattr(finish, "finish", altered)


def _late_notes(monkeypatch):
    """Live notes played one tick after the one they were sent for."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    def send(self, note, channel, set_on=True, velocity=64):
        self.schedule_note(note, channel, set_on, velocity, 0, 1)

    monkeypatch.setattr(AudioEngine, "send_note_immediately", send)


FAULTS = [("bounce-96v", None, _frozen), ("live-loops", None, _frozen),
          ("bounce-96v", None, _half_voices),
          ("live-loops", KEYS, _half_voices),
          ("bounce-96v", None, _altered), ("live-loops", None, _altered),
          ("live-loops", KEYS, _late_notes)]


@pytest.mark.parametrize(
    "name,traffic,fault", FAULTS,
    ids=[f"{n}{'-keys' if t else ''}-{f.__name__[1:]}" for n, t, f in FAULTS])
def test_broken_path_is_not_correct(monkeypatch, name, traffic, fault):
    fault(monkeypatch)
    line, checks, _ = run_tiny(name, seconds=0.6, traffic=traffic)
    assert not line["correct"], checks


def test_reference_imports_nothing_of_the_program():
    import ast
    from zlbench import reference, check, session, roofline
    for mod in (reference, check, session, roofline):
        tree = ast.parse(open(mod.__file__).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "libzl_tpu_torch", "libzl_tpu", "jax"), (mod, n)
    assert torch is not None
