"""The port's span record (libzl_tpu_torch/utils/profiling.py) on the CPU:
spans nest with their parent, thread and block in a bounce through the C
ABI runtime and in a lookahead engine's speculative chain; the totals, the
window, phase_stats, the timeline's switch, capacity, collections and
clock; and the benchmark's readers of the record (zlbench/program.py, the
metrics that read the program's totals) on synthetic inputs."""

import gc
import time

import numpy as np
import pytest

from libzl_tpu_torch.capi.bridge import EngineRuntime
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.engine.graphs import DISPATCH_SPANS
from libzl_tpu_torch.io.sinks import AudioSink
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.utils import profiling
from libzl_tpu_torch.utils.profiling import BlockProfiler
from zlbench import harness, program, spec

SR = 48000


class _Sink(AudioSink):
    pacing = False

    def write(self, block):
        pass


def _tone(seconds=0.5):
    t = np.arange(int(SR * seconds)) / SR
    return AudioData((0.4 * np.sin(2 * np.pi * 220 * t)).astype(
        np.float32)[:, None], SR)


def _play(eng, clip, note=60):
    cmd = ClipCommand.channel(clip.id, 0)
    cmd.midi_note = note
    cmd.change_volume = True
    cmd.volume = 0.8
    cmd.start_playback = True
    cmd.looping = True
    cmd.change_looping = True
    eng.schedule_clip_command(cmd, 0)


@pytest.fixture
def recorded():
    """The timeline on for the test, off after it. The timeline records
    every thread, so the process-wide speculative workers first finish
    what engines of earlier tests in this process left them."""
    AudioEngine._spec_sim_executor().submit(lambda: None).result()
    AudioEngine._spec_executor().submit(lambda: None).result()
    profiling.start_recording(1 << 16)
    yield
    profiling.stop_recording()


def _by_id(spans):
    return {s["id"]: s for s in spans}


def test_bounce_spans_nest_by_block(recorded):
    """A bounce through the runtime's drain: each block's root `step`
    holds the engine's process_block, which holds commands, host_program
    and dispatch (the graph replay's parts below it); a flush_deliver
    holds each block's flush_sink and a cadence block's flush_session; all
    on the caller's thread, children carrying their block."""
    rt = EngineRuntime(device="cpu", block_frames=256, num_voices=16,
                       lookahead=0, bounce_drain=4)
    rt.set_sink(_Sink())
    clip = ClipAudioSource(rt.engine, audio=_tone())
    rt.engine.start_transport(bpm=120)
    _play(rt.engine, clip)
    rt.engine.warmup()
    since = profiling.mark()
    rt.step_blocks(12)
    spans = profiling.export(since)["spans"]
    ids = _by_id(spans)
    assert {s["thread"] for s in spans if s["name"] != "gc"} == {"engine"}
    steps = [s for s in spans if s["name"] == "step"]
    assert [s["block"] for s in steps] == list(range(1, 13))
    assert all(s["parent"] is None for s in steps)
    blocks = [s for s in spans if s["name"] == "process_block"]
    assert len(blocks) == 12
    for b in blocks:
        parent = ids[b["parent"]]
        assert parent["name"] == "step" and parent["block"] == b["block"]
        assert parent["start_ns"] <= b["start_ns"] <= b["end_ns"] \
            <= parent["end_ns"]
    for name in ("commands", "host_program", "dispatch"):
        got = [s for s in spans if s["name"] == name]
        assert len(got) == 12, name
        for s in got:
            assert ids[s["parent"]]["name"] == "process_block"
            assert ids[s["parent"]]["block"] == s["block"]
    for name in DISPATCH_SPANS:
        got = [s for s in spans if s["name"] == name]
        assert len(got) == 12, name
        assert all(ids[s["parent"]]["name"] == "dispatch" for s in got)
    delivers = [s for s in spans if s["name"] == "flush_deliver"]
    assert len(delivers) == 3
    sinks = [s for s in spans if s["name"] == "flush_sink"]
    assert sorted(s["block"] for s in sinks) == list(range(1, 13))
    assert all(ids[s["parent"]]["name"] == "flush_deliver"
               for s in sinks)
    sessions = [s for s in spans if s["name"] == "flush_session"]
    every = rt.engine._levels_every
    assert sorted(s["block"] for s in sessions) == [
        b for b in range(1, 13) if b % every == 0]
    totals = rt.phase_stats()
    assert totals["step_n"] == 12 and totals["process_block_n"] == 12
    assert totals["flush_sink_n"] == 12


def test_live_chain_worker_spans_carry_their_link(recorded):
    """A lookahead engine's speculative chain: each link's spec_sim (on
    the sim thread) carries the link's first block and names as its parent
    the engine span that launched or adopted it; its spec_dispatch (on the
    dispatch thread) names the spec_sim, holds the replay's parts, and the
    link is adopted at its block."""
    eng = AudioEngine("cpu", block_frames=128, num_voices=16)
    clip = ClipAudioSource(eng, audio=_tone())
    eng.start_transport(bpm=120)
    _play(eng, clip)
    eng.warmup()
    H = eng._lookahead
    since = profiling.mark()
    for _ in range(4 + 3 * H):
        eng.process_block()
    eng.drain_speculation()
    spans = profiling.export(since)["spans"]
    ids = _by_id(spans)
    sims = [s for s in spans if s["name"] == "spec_sim"]
    disp = [s for s in spans if s["name"] == "spec_dispatch"]
    assert sims and disp
    assert {s["thread"] for s in sims} == {"spec-sim"}
    assert {s["thread"] for s in disp} == {"spec-dispatch"}
    # the first horizon starts at block 4: its chain's links at 4 + kH
    assert [s["block"] for s in sims] == [4 + H * (k + 1)
                                         for k in range(len(sims))]
    for s in sims:
        cause = ids[s["parent"]]
        assert cause["thread"] == "engine" and cause["block"] < s["block"]
    for d in disp:
        assert ids[d["parent"]]["name"] == "spec_sim"
        assert ids[d["parent"]]["block"] == d["block"]
    inner = [s for s in spans if s["name"] in DISPATCH_SPANS
             and s["thread"] == "spec-dispatch"]
    assert inner and all(ids[s["parent"]]["name"] == "spec_dispatch"
                         for s in inner)
    adopted = {s["block"] for s in spans if s["name"] == "adopt_wait"}
    processed = {s["block"] for s in spans if s["name"] == "process_block"}
    assert {s["block"] for s in sims if s["block"] in processed} <= adopted
    for name in ("commands", "lookahead"):
        assert all(ids[s["parent"]]["name"] == "process_block"
                   for s in spans if s["name"] == name)
    emits = [s for s in spans if s["name"] == "emit"]
    assert all(ids[s["parent"]]["name"] == "lookahead" for s in emits)
    st = eng.stats()
    assert st["lookahead_slices_emitted"] == len(emits)
    assert st["lookahead_slices_rendered"] == H * (
        eng.render_dispatches["horizon"])
    # drain_speculation let go of the chain's queued links: rendered, never
    # emitted
    assert st["lookahead_slices_rendered"] > len(emits)


def test_totals_count_past_the_window():
    prof = BlockProfiler()
    for _ in range(3000):
        with prof.span("x"):
            pass
    prof.record("x", 0.25)
    t = prof.totals()["x"]
    assert t["count"] == 3001 and t["max_s"] >= 0.25
    assert t["total_s"] >= 0.25
    assert prof.summary()["x"]["count"] == 2048


def test_summary_reads_as_before():
    rng = np.random.default_rng(3)
    prof = BlockProfiler(window=64)
    values = rng.exponential(0.002, 200)
    for v in values:
        prof.record("host", float(v))
    a = values[-64:] * 1e3
    assert prof.summary() == {"host": {
        "p50_ms": float(np.percentile(a, 50)),
        "p90_ms": float(np.percentile(a, 90)),
        "p99_ms": float(np.percentile(a, 99)),
        "max_ms": float(a.max()), "count": 64}}


def test_phase_stats_on_a_scripted_sequence():
    rt = EngineRuntime(device="cpu", num_voices=16)
    for name, dt in (("render", 0.0021), ("render", 0.0009),
                     ("copy_wait", 0.0005), ("flush_sync", 0.00004),
                     ("render", 0.01)):
        rt._phase(name, dt)
    assert rt.phase_stats() == {
        "copy_wait_ms": 0.5, "copy_wait_n": 1, "flush_sync_ms": 0.0,
        "flush_sync_n": 1, "render_ms": 13.0, "render_n": 3,
        "stage_ring_blocks": 0, "stage_ring_fallbacks": 0}


def test_nothing_recorded_while_off():
    profiling.stop_recording()
    assert not profiling.recording()
    assert profiling.current() is None
    since = profiling.mark()
    prof = BlockProfiler()
    with prof.span("off", block=1) as sp:
        gc.collect()
    assert sp.id is None and sp.ns > 0
    assert profiling.export(since)["spans"] == []
    assert gc.callbacks.count(profiling._gc_hook) == 0


def test_overflow_counts_in_dropped():
    profiling.start_recording(5)
    try:
        prof = BlockProfiler()
        for i in range(8):
            with prof.span("s", block=i):
                pass
    finally:
        profiling.stop_recording()
    got = profiling.export()
    assert [s["block"] for s in got["spans"]] == [0, 1, 2, 3, 4]
    assert got["dropped"] == 3


def test_collection_is_a_span(recorded):
    since = profiling.mark()
    prof = BlockProfiler()
    with prof.span("outer", block=7) as outer:
        gc.collect()
    spans = profiling.export(since)["spans"]
    runs = [s for s in spans if s["name"] == "gc"]
    assert runs and runs[-1]["generation"] == 2
    assert runs[-1]["thread"] == "engine"
    assert runs[-1]["parent"] == outer.id and runs[-1]["block"] == 7


def test_exported_times_are_on_the_wall_clock(recorded):
    prof = BlockProfiler()
    since = profiling.mark()
    a = time.time_ns()
    with prof.span("inside"):
        time.sleep(0.002)
    b = time.time_ns()
    (s,) = profiling.export(since)["spans"]
    assert a <= s["start_ns"] < s["end_ns"] <= b
    assert s["end_ns"] - s["start_ns"] >= 2_000_000


def test_innermost_and_name_gaps():
    """Nested spans of one thread; a gap's time goes, piece by piece, to
    the innermost span over it, else to the harness call, else to
    "harness between calls"."""
    spans = [(0, 100, "step"), (10, 60, "process_block"),
             (20, 40, "dispatch"), (25, 30, "dispatch_stage"),
             (70, 90, "sink")]
    assert program.innermost(spans) == [
        (0, 10, "step"), (10, 20, "process_block"), (20, 25, "dispatch"),
        (25, 30, "dispatch_stage"), (30, 40, "dispatch"),
        (40, 60, "process_block"), (60, 70, "step"), (70, 90, "sink"),
        (90, 100, "step")]
    log = [("runtime step_blocks", -50, 120)]
    gaps = [(-100, -60), (-40, 5), (22, 28), (55, 75), (95, 130)]
    got = program.name_gaps(gaps, spans, log)
    want = {"harness between calls": (40 + 10, 2, 40),
            "runtime step_blocks": (40 + 20, 2, 40),
            "step": (5 + 10 + 5, 3, 10), "dispatch": (3, 1, 3),
            "dispatch_stage": (3, 1, 3), "process_block": (5, 1, 5),
            "sink": (5, 1, 5)}
    assert set(got) == set(want)
    for k, (s, n, longest) in want.items():
        assert got[k][0] == pytest.approx(s / 1e9), k
        assert got[k][1] == n, k
        assert got[k][2] == pytest.approx(longest / 1e9), k


def test_innermost_cuts_a_span_at_its_parent():
    assert program.innermost([(0, 10, "a"), (5, 20, "b")]) == [
        (0, 5, "a"), (5, 10, "b")]


def _run(drive="live", blocks=4, **kw):
    run = harness.Run("cell", drive, 128, SR, 1.0, blocks=blocks,
                      window_s=blocks * 128 / SR)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


@pytest.mark.parametrize("name,drive,phases,want", [
    ("commands_ms.live", "live", {"commands": (0.002, 4)}, 0.5),
    ("commands_ms.bounce", "bounce", {"commands": (0.004, 4)}, 1.0),
    ("bridge_ms.live", "live",
     {"step": (0.010, 4), "process_block": (0.006, 4)}, 1.0),
    ("flush_session_ms.bounce", "bounce",
     {"flush_session": (0.0008, 2)}, 0.2),
])
def test_totals_readers(name, drive, phases, want):
    """Each reader of the program's totals on a synthetic run; None where
    the program has no such span (a parent commit) or the drive is not
    the metric's."""
    read = spec.reader(name)
    assert read(_run(drive, phases=phases)) == pytest.approx(want)
    assert read(_run(drive, phases={"copy_wait": (0.1, 4)})) is None
    other = "bounce" if drive == "live" else "live"
    assert read(_run(other, phases=phases)) is None


def test_record_readers():
    period = 128 / SR
    t0 = 1_000_000_000
    ms = 1_000_000

    def sp(name, a, b, thread="engine", block=None):
        return {"name": name, "start_ns": t0 + a * ms, "end_ns": t0 + b * ms,
                "thread": thread, "block": block, "parent": None, "id": 0}

    record = {"spans": [
        sp("step", 0, 1, block=11), sp("step", 9, 10, block=12),
        sp("step", 6, 9, block=13), sp("step", 10, 11, block=14),
        sp("spec_sim", 2, 7, "spec-sim", 99),
        sp("spec_dispatch", 5, 8, "spec-dispatch", 99)]}
    assert program.spec_busy_pct(record, t0, t0 + 20 * ms) == \
        pytest.approx(30.0)
    due = np.arange(4) * period
    run = _run("live", due=due, delivered=due + np.array(
        [0.0, 2.0, 2.0, 0.0]) * period)
    # blocks 1 and 2 are late: 12 (9-10 ms) and 13 (6-9 ms); only 13
    # overlaps the workers' 2-8 ms
    assert program.late_spec_pct(run, record) == pytest.approx(50.0)
    run.delivered = due
    assert program.late_spec_pct(run, record) is None
    before = {"lookahead_slices_rendered": 32, "lookahead_slices_emitted": 20}
    after = {"lookahead_slices_rendered": 96, "lookahead_slices_emitted": 68}
    assert program.lookahead_useful_pct(before, after) == pytest.approx(75.0)
    assert program.lookahead_useful_pct(before, before) is None


def test_union_of_intervals():
    assert program.union([(10, 20), (15, 30), (40, 50)]).tolist() == [
        [10, 30], [40, 50]]
    assert program.union([(5, 9), (0, 3), (3, 4)]).tolist() == [
        [0, 4], [5, 9]]
    assert program.union([]).shape == (0, 2)


@pytest.mark.parametrize("how", ["retire", "collect"])
def test_a_gone_graph_folds_its_replays_into_the_counts(how):
    """A graph's replays count in its kernels' launches while it lives, and
    once it is retired (rebind) or collected they are folded into the
    counts, once, and it is no longer walked at a read."""
    from libzl_tpu_torch.ops import finish, launch_tally

    class Graph:
        pass

    before = finish.finish.launches
    graph = Graph()
    replays = launch_tally.Replays({"finish_block": 2}, graph)
    replays.n = 3
    assert finish.finish.launches == before + 6
    if how == "retire":
        launch_tally.retire(replays)
        assert launch_tally.counts()["finish_block"] == before + 6
        assert replays not in launch_tally._replayed
    del graph
    gc.collect()
    assert finish.finish.launches == before + 6
    assert replays not in launch_tally._replayed
    finish.finish.launches = before
