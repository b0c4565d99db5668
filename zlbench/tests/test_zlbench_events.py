"""Event kinds: a mix's timed commands found by file (`events/<key>.py`).
The notes kind gives what the harness gave before it had kinds (digests
frozen from that harness: the notes, the send order, the reference's
events, the kept and the sampled blocks), a bounce cell naming a kind is
refused, and a run reads the engine's counters over its window."""

import dataclasses
import hashlib
import json

import pytest

from zlbench import check, harness, session, spec
from zlbench.tests.tiny import KEYS, run_tiny, tiny_cell

SEEDS = (2 ** 31 + 12345, 2 ** 33 + 1, 7)
# (notes, sends, events, kept, sampled) for seq-80 in live-seq-b256 over
# 30 s, and KEYS in the tiny live-loops over 3 s
FROZEN = {
    ("seq-80", SEEDS[0]): ("aa8d714be2232565", "3c1ae1f69193e732",
                           "3658b9289eadb911", "c3eb1d59eda2bffb",
                           "4caad4e8de08bf21"),
    ("seq-80", SEEDS[1]): ("f1d8c49a7cb1d710", "3d8c838034a714ec",
                           "c5bea479a4bfdba2", "83d0da24462dc4fa",
                           "6c4d9996d9e2fb7c"),
    ("seq-80", SEEDS[2]): ("95bec1949c1a338f", "fe109b5d44e47031",
                           "c02a825b94d8b6c5", "b0314fd08dc687a3",
                           "cc850b2c1e026f9c"),
    ("keys", SEEDS[0]): ("4dc68d76a55b7e63", "66c9246f62985e35",
                         "4e2358ffafafd441", "6c98e13d58d68c78",
                         "4b6a34b2d0c7cd9c"),
    ("keys", SEEDS[1]): ("91d772165a0420e6", "6237bf56d8fcdbe5",
                         "5235898206368c9a", "85af045fcced9b21",
                         "bbd44144b833aaf9"),
    ("keys", SEEDS[2]): ("54363483f00601f5", "e4c27dd0a60bd26b",
                         "40d5b5c512221395", "8106fd11a2a81f32",
                         "ce97602796b73919"),
}


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


def _window(cell, seed: int, seconds: float) -> harness.Window:
    """A run's window without the program: the session's plain inputs."""
    cfg = cell.config
    clips = int(cfg["clips"])
    s = harness.Session(None, None, [None] * clips, session.loop_plan(
        int(cell.traffic["loop_voices"]), clips, seed), [],
        int(cfg["setup_blocks"]))
    return harness.Window(cell, s, seed, seconds,
                          cfg["block_frames"] / cfg["sample_rate"])


@pytest.mark.parametrize("mix,seed", sorted(FROZEN))
def test_notes_kind_gives_what_the_harness_gave(mix, seed):
    cell = (spec.load_cell("live-seq-b256") if mix == "seq-80"
            else tiny_cell("live-loops", traffic=KEYS))
    w = _window(cell, seed, 30.0 if mix == "seq-80" else 3.0)
    plans = harness.plan_events(w)
    assert [k for k, _, _ in cell.kinds] == ["notes"]
    (_, plan), = plans
    sends = [[blk, on, note.channel, note.pitch, note.velocity]
             for blk, (on, note) in plan.commands]
    events = harness.events_for(w, plans)
    keep = check.keep_rule(seed, w.first, plan.keep)
    kept = [i for i in range(w.first, w.first + w.blocks) if keep(i)]
    sampled = check.sample_blocks(seed, w.first, w.blocks, events, kept)
    got = (
        _digest([list(dataclasses.astuple(n))
                 for n in plan.state["notes"]]),
        _digest(sends),
        _digest([[type(e).__name__] + list(dataclasses.astuple(e))
                 for e in events]),
        _digest(kept), _digest(sampled))
    assert got == FROZEN[(mix, seed)]


def test_every_mix_names_kinds_with_their_four_calls():
    for name in (w["name"] for w in spec.load_benchmark()["workloads"]):
        for key, mod, params in spec.load_cell(name).kinds:
            assert params is not None
            for fn in ("plan", "send", "read", "events"):
                assert callable(getattr(mod, fn)), (key, fn)


def test_a_bounce_cell_naming_a_kind_is_refused():
    bounce = spec.load_cell("bounce-96v")
    assert bounce.kinds == []
    with pytest.raises(ValueError, match="sends nothing in its window"):
        spec.event_kinds(KEYS, bounce.config)
    with pytest.raises(ValueError, match="sends nothing in its window"):
        tiny_cell("bounce-96v", traffic=KEYS)


def test_an_unknown_kind_is_refused():
    with pytest.raises(KeyError, match="events/no_such_kind.py"):
        spec.event_kinds({"loop_voices": 8, "no_such_kind": {}},
                         spec.load_cell("live-loops").config)


def test_counters_count_the_windows_notes(monkeypatch):
    """`Run.counters` is the window's difference of `engine.stats()`: a
    tiny KEYS run's note-ons are the notes the window sent that took
    effect in it (a note sent for the last block may sound after it)."""
    seen = {}
    reader, events_for = spec.reader, harness.events_for

    def spy_reader(name):
        def read(run):
            seen["run"] = run
            return reader(name)(run)
        return read

    def spy_events(w, plans):
        seen["events"] = events_for(w, plans)
        seen["first"] = w.first
        return seen["events"]

    monkeypatch.setattr(spec, "reader", spy_reader)
    monkeypatch.setattr(harness, "events_for", spy_events)
    line, checks, _ = run_tiny("live-loops", traffic=KEYS, seconds=0.5)
    assert line["correct"], checks
    run = seen["run"]
    end = seen["first"] + run.blocks
    played = [e for e in seen["events"]
              if not getattr(e, "looping", False) and e.block < end]
    ons = sum(type(e).__name__ == "Start" for e in played)
    offs = sum(type(e).__name__ == "Stop" for e in played)
    assert ons > 0 and offs > 0
    assert run.counters["note_ons"] == ons
    assert run.counters["note_offs"] == offs
    assert run.counters["blocks"] == run.blocks
    assert all(not isinstance(v, bool) for v in run.counters.values())
