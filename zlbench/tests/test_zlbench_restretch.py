"""The `restretch` event kind's plan, read and events, on a stand-in for a
run's window (no engine renders here): the same command count and
kept-block rule for every seed, steps that reflect at the controls' ends,
and one `Reload` per applied render, none for a superseded generation."""

import collections
import types

import numpy as np
import pytest

from zlbench import reference, session, spec, stretch
from zlbench.events import restretch

CELL = spec.load_cell("live-restretch-b256")
PARAMS = CELL.traffic["restretch"]
PERIOD = 256 / 48000
FIRST = 48


def _window(seed: int, params=PARAMS, seconds: float = 30.0, clips=None):
    """A stand-in harness.Window: the cell's configuration, the mix's 64
    loops over 64 clips, an engine with an empty record, 48 set-up blocks
    delivered."""
    clips = clips or [session.Clip(np.zeros((8, 2), np.float32), 1)] * 64
    engine = types.SimpleNamespace(applied_renders=collections.deque(),
                                   total_blocks=FIRST + 3)
    ports = [types.SimpleNamespace(id=100 + i, _render_generation=0)
             for i in range(len(clips))]
    sess = types.SimpleNamespace(
        rt=types.SimpleNamespace(engine=engine),
        sink=types.SimpleNamespace(count=FIRST), clips=clips,
        loops=session.loop_plan(64, len(clips), seed), port_clips=ports)
    cell = types.SimpleNamespace(config=CELL.config)
    return types.SimpleNamespace(cell=cell, session=sess, seed=seed,
                                 seconds=seconds, period_s=PERIOD,
                                 first=FIRST,
                                 blocks=int(np.ceil(seconds / PERIOD)))


SEEDS = [1, 7, 2 ** 31 + 5, 3 * 2 ** 31 - 17]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_sends_56_commands_and_keeps_after_each(seed):
    w = _window(seed)
    plan = restretch.plan(PARAMS, w)
    assert len(plan.commands) == 56
    blocks = [b for b, _ in plan.commands]
    assert blocks == sorted(blocks) and blocks[-1] < w.blocks
    keep_blocks = int(np.ceil(PARAMS["keep_s"] / PERIOD))
    want = set()
    for b in blocks:
        want.update(range(FIRST + b - 1, FIRST + b + keep_blocks + 1))
    assert plan.keep == want
    # four steps 120 ms apart on one clip, pitch and speed in turns
    for k in range(14):
        turn = [c for _, c in plan.commands[4 * k:4 * k + 4]]
        assert len({c["clip"] for c in turn}) == 1
        assert {c["control"] for c in turn} == {("pitch", "speed")[k % 2]}
        gaps = np.diff(blocks[4 * k:4 * k + 4]) * PERIOD
        assert np.all(np.abs(gaps - 0.120) < PERIOD)
    assert {c["clip"] for _, c in plan.commands} <= {
        v.clip for v in w.session.loops}


def test_a_shorter_window_sends_the_turns_that_fit():
    counts = {restretch_count(seed, 10.0) for seed in SEEDS}
    assert counts == {16}


def restretch_count(seed, seconds):
    return len(restretch.plan(PARAMS, _window(seed, seconds=seconds))
               .commands)


@pytest.mark.parametrize("seed", SEEDS)
def test_steps_reflect_at_the_ends(seed):
    narrow = dict(PARAMS, steps=6, pitch={"step": 1, "range": [-1, 2]},
                  speed={"step": 0.05, "range": [0.95, 1.05]})
    plan = restretch.plan(narrow, _window(seed, narrow))
    last = collections.defaultdict(lambda: {"pitch": 0.0, "speed": 1.0})
    for _, c in plan.commands:
        prev = last[c["clip"]][c["control"]]
        v = c["value"]
        if c["control"] == "pitch":
            assert -1 <= v <= 2 and abs(v - prev) == 1
        else:
            assert 0.95 - 1e-6 <= v <= 1.05 + 1e-6
            assert abs(abs(v - prev) - 0.05) < 1e-6
        last[c["clip"]][c["control"]] = v
        assert c["state"] == last[c["clip"]]
    # a turn of six steps over a range of three steps must turn back
    values = [c["value"] for _, c in plan.commands[:6]]
    assert len(set(values)) < 6


def test_values_are_c_floats():
    plan = restretch.plan(PARAMS, _window(3))
    for _, c in plan.commands:
        assert c["value"] == float(np.float32(c["value"]))


def _applied(w, plan, keep_gens):
    """Send every command (the stand-in clips count generations), then
    record as applied those of the generations `keep_gens` picks, each two
    blocks after its send."""
    for block, cmd in plan.commands:
        port = w.session.port_clips[cmd["clip"]]
        port._render_generation += 1
        cmd["gen"] = port._render_generation
    offset = plan.state["offset"]
    engine = w.session.rt.engine
    for block, cmd in plan.commands:
        if keep_gens(cmd):
            engine.applied_renders.append(
                (FIRST + block + 2 + offset,
                 w.session.port_clips[cmd["clip"]].id, cmd["gen"]))


def test_a_superseded_generation_gives_no_reload():
    rng = np.random.default_rng(4)
    clips = [session.Clip(rng.normal(0, 0.1, (6000, 2)).astype(np.float32),
                          1) for _ in range(64)]
    w = _window(11, clips=clips)
    plan = restretch.plan(PARAMS, w)
    # of each turn only its last step's render is applied
    last = {id(c) for c in [plan.commands[i][1] for i in range(3, 56, 4)]}
    _applied(w, plan, lambda cmd: id(cmd) in last)
    restretch.read(plan, w)
    events = restretch.events(plan, w)
    assert len(events) == 14
    for ev, (block, cmd) in zip(events, plan.commands[3::4]):
        assert isinstance(ev, reference.Reload)
        assert ev.block == FIRST + block + 2 and ev.clip == cmd["clip"]
        want = stretch.render_playback(clips[cmd["clip"]].audio,
                                       cmd["state"]["speed"],
                                       cmd["state"]["pitch"], 0.0, 48000)
        assert np.array_equal(ev.audio, want)


def test_a_render_outside_the_kept_blocks_fails_the_run():
    w = _window(12)
    plan = restretch.plan(PARAMS, w)
    _applied(w, plan, lambda cmd: True)
    engine = w.session.rt.engine
    b, cid, gen = engine.applied_renders[-1]
    engine.applied_renders[-1] = (b + 10_000, cid, gen)
    with pytest.raises(RuntimeError, match="outside the blocks kept"):
        restretch.read(plan, w)


def test_a_render_no_command_sent_fails_the_run():
    w = _window(13)
    plan = restretch.plan(PARAMS, w)
    _applied(w, plan, lambda cmd: True)
    b, cid, gen = w.session.rt.engine.applied_renders[0]
    w.session.rt.engine.applied_renders.append((b, cid, gen + 1000))
    with pytest.raises(RuntimeError, match="no command sent"):
        restretch.read(plan, w)
