"""The played notes' path of the port's engine on the CPU: the span `notes`
(the MIDI fabric of a block whose scheduled MIDI carries a note), the
counters of AudioEngine.stats() (note_ons, note_offs, starts_dropped,
bucket_changes), the engine's outputs with the span record's timeline on
and off, and the benchmark's readers of the span."""

import types

import numpy as np
import pytest
import torch

from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.midi.messages import is_note_off, is_note_on
from libzl_tpu_torch.midi.router import Destination
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.utils import profiling
from zlbench import spec

SR = 48000
CHANNELS = 4
# (block frames, lookahead): the card's per-block path at its live and
# bounce blocks, and the lookahead horizon
SETTINGS = [(256, 0), (1024, 0), (128, 8), (256, 8)]
IDS = [f"B{b}-H{h}" for b, h in SETTINGS]


def _audio(seconds: float, f0: float) -> AudioData:
    t = np.arange(int(SR * seconds)) / SR
    x = 0.3 * np.sin(2 * np.pi * f0 * t)
    return AudioData(np.stack([x, 0.5 * x], 1).astype(np.float32), SR)


def _engine(block_frames: int, lookahead: int, num_voices: int = 96,
            loops: int = 8):
    """An engine whose channels 0..CHANNELS-1 play their notes from one
    clip each, `loops` looped voices (clip commands, not notes) started in
    block 0, warmed up."""
    eng = AudioEngine("cpu", block_frames=block_frames,
                      num_voices=num_voices, lookahead=lookahead)
    clips = [ClipAudioSource(eng, audio=_audio(0.5, 110.0 * (i + 1)))
             for i in range(CHANNELS)]
    for ch, clip in enumerate(clips):
        eng.router.set_channel_destination(ch, Destination.SAMPLER)
        eng.sampler_map.assign(ch, clip)
    eng.start_transport(bpm=120)
    for v in range(loops):
        cmd = ClipCommand.channel(clips[v % CHANNELS].id, v % CHANNELS)
        cmd.midi_note = 36 + v
        cmd.change_volume = True
        cmd.volume = 0.5
        cmd.looping = True
        cmd.start_playback = True
        eng.schedule_clip_command(cmd, 0)
    eng.warmup()
    return eng


def _stream(seed: int, blocks: int, per_block: float = 0.3):
    """Seeded note traffic: block -> [(on, pitch, channel, velocity)],
    each note released 1-6 blocks after it starts; its pitches leave the
    loops' alone."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for b in range(blocks):
        for _ in range(rng.poisson(per_block)):
            pitch, ch = int(rng.integers(60, 84)), int(rng.integers(0,
                                                                  CHANNELS))
            vel = int(rng.integers(40, 128))
            out.setdefault(b, []).append((True, pitch, ch, vel))
            off = b + int(rng.integers(1, 7))
            if off < blocks:
                out.setdefault(off, []).append((False, pitch, ch, 64))
    return out


def _play(eng, stream: dict, blocks: int) -> list:
    """Send each block's notes (offs first), process it; the masters."""
    masters = []
    for b in range(blocks):
        for on, pitch, ch, vel in sorted(stream.get(b, ()),
                                         key=lambda n: n[0]):
            eng.send_note_immediately(pitch, ch, on, vel)
        masters.append(eng.process_block().outputs.master.clone())
    return masters


def _spy_note_blocks(eng) -> list:
    """The blocks (engine.total_blocks + 1 as they are routed) whose
    scheduled MIDI reaches the router with a note-on or off in it: a note
    sent between blocks waits in the step ring for the next tick, which a
    block shorter than a tick may not hold."""
    blocks = []
    route = eng.router.route_internal

    def route_internal(events):
        if any(is_note_on(d) or is_note_off(d) for _, d in events):
            blocks.append(eng.total_blocks + 1)
        route(events)

    eng.router.route_internal = route_internal
    return blocks


def _settle(eng, blocks: int = 4) -> None:
    """Process blocks until the notes sent have reached a tick."""
    for _ in range(blocks):
        eng.process_block()


@pytest.mark.parametrize("block_frames,lookahead", SETTINGS, ids=IDS)
def test_notes_span_once_a_note_block(block_frames, lookahead):
    """The span's count is the note blocks; quiet blocks never enter it;
    its total lies inside the commands'."""
    eng = _engine(block_frames, lookahead)
    eng.process_block()         # block 0's loop starts
    eng.profiler = type(eng.profiler)()
    seen = _spy_note_blocks(eng)
    _play(eng, _stream(11, 40), 40)
    totals = eng.profiler.totals()
    assert totals["notes"]["count"] == len(seen) > 5
    assert totals["commands"]["count"] == 40
    assert totals["notes"]["total_s"] < totals["commands"]["total_s"]


@pytest.mark.parametrize("block_frames,lookahead", SETTINGS, ids=IDS)
def test_notes_span_nests_under_commands(block_frames, lookahead):
    """In the timeline each `notes` span is the child of its block's
    `commands`, inside it, and carries the block."""
    eng = _engine(block_frames, lookahead)
    seen = _spy_note_blocks(eng)
    profiling.start_recording(1 << 15)
    try:
        since = profiling.mark()
        _play(eng, _stream(12, 24), 24)
        spans = profiling.export(since)["spans"]
    finally:
        profiling.stop_recording()
    ids = {s["id"]: s for s in spans}
    notes = [s for s in spans if s["name"] == "notes"]
    assert [s["block"] for s in notes] == seen and len(seen) > 3
    for s in notes:
        parent = ids[s["parent"]]
        assert parent["name"] == "commands"
        assert parent["block"] == s["block"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]
        assert ids[parent["parent"]]["name"] == "process_block"


@pytest.mark.parametrize("block_frames,lookahead", SETTINGS, ids=IDS)
def test_note_counts_equal_the_messages_sent(block_frames, lookahead):
    eng = _engine(block_frames, lookahead, loops=0)
    before = eng.stats()
    stream = _stream(13, 48, per_block=0.5)
    _play(eng, stream, 48)
    _settle(eng)
    sent = [n for notes in stream.values() for n in notes]
    st = eng.stats()
    assert st["note_ons"] - before["note_ons"] == sum(n[0] for n in sent)
    assert st["note_offs"] - before["note_offs"] == sum(
        not n[0] for n in sent)
    assert st["starts_dropped"] == 0
    # a note-on of velocity 0 is a note-off
    eng.send_note_immediately(61, 0, True, 0)
    _settle(eng)
    assert eng.stats()["note_offs"] == st["note_offs"] + 1


MESSAGES = [bytes([0x90, 60, 100]), bytes([0x93, 61, 0]),
            bytes([0x80, 62, 64]), bytes([0x8F, 63]), bytes([0x9F, 64]),
            bytes([0xF8]), bytes([0xB0, 7, 100])]


@pytest.mark.parametrize("data", MESSAGES, ids=[m.hex() for m in MESSAGES])
def test_note_counts_follow_the_message_helpers(data):
    """The engine tells note-ons from note-offs as midi.messages does: a
    velocity-0 note-on is an off, a truncated note-on neither; a block
    whose MIDI holds neither enters no span."""
    eng = _engine(256, 0, loops=0)
    eng.schedule_midi(data, 0)
    _settle(eng)
    st = eng.stats()
    assert (st["note_ons"], st["note_offs"]) == (int(is_note_on(data)),
                                                 int(is_note_off(data)))
    notes = eng.profiler.totals().get("notes", {"count": 0})["count"]
    assert notes == int(is_note_on(data) or is_note_off(data))


@pytest.mark.parametrize("block_frames,lookahead", SETTINGS[:3],
                         ids=IDS[:3])
def test_starts_dropped_counts_a_start_into_a_full_pool(block_frames,
                                                       lookahead):
    """32 voices, 30 loops: of five note-ons in one block, two find an idle
    voice and three are dropped, as the reference's allocator drops
    them."""
    eng = _engine(block_frames, lookahead, num_voices=32, loops=30)
    eng.process_block()
    assert eng.stats()["starts_dropped"] == 0
    assert int(eng.pool.active.sum()) == 30
    for i in range(5):
        eng.send_note_immediately(70 + i, i % CHANNELS, True, 90)
    _settle(eng)
    st = eng.stats()
    assert st["starts_dropped"] == 3 and st["note_ons"] == 5
    assert int(eng.pool.active.sum()) == 32


@pytest.mark.parametrize("block_frames", [256, 1024, 128])
def test_bucket_changes_count_a_bucket_step(block_frames):
    """96 voices render the 64-voice bucket while the 64 loops play; a
    note on voice 64 steps the render up to the whole pool, and its death
    after the release steps it back: two changes."""
    eng = _engine(block_frames, 0, loops=64)
    eng.process_block()
    assert eng._render_bucket() == 64
    assert eng.stats()["bucket_changes"] == 0
    eng.send_note_immediately(80, 1, True, 100)
    _settle(eng)
    assert eng.stats()["bucket_changes"] == 1
    eng.send_note_immediately(80, 1, False, 64)
    # the release (0.05 s) and the block the voice dies in
    for _ in range(int(0.05 * SR / block_frames) + 4):
        eng.process_block()
    assert eng._render_bucket() == 64
    assert eng.stats()["bucket_changes"] == 2
    for _ in range(3):
        eng.process_block()
    assert eng.stats()["bucket_changes"] == 2


@pytest.mark.parametrize("block_frames,lookahead",
                         [(256, 0), (128, 8), (1024, 0)],
                         ids=["B256-H0", "B128-H8", "B1024-H0"])
def test_outputs_bit_equal_with_the_timeline_on_and_off(block_frames,
                                                       lookahead):
    stream = _stream(2 ** 31 + 77, 64, per_block=0.4)
    off = _play(_engine(block_frames, lookahead), stream, 64)
    on_engine = _engine(block_frames, lookahead)
    profiling.start_recording(1 << 16)
    try:
        on = _play(on_engine, stream, 64)
    finally:
        profiling.stop_recording()
    assert len(on) == len(off) == 64
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert on_engine.stats()["note_ons"] > 8
    assert any(bool(a.abs().max() > 0) for a in on)


def _run(phases: dict, spans: dict, blocks: int = 100):
    return types.SimpleNamespace(drive="live", blocks=blocks, phases=phases,
                                 spans=spans)


NOTES = {"p50_ms": 0.01, "p90_ms": 0.02, "p99_ms": 0.04, "max_ms": 0.05,
         "count": 30}


@pytest.mark.parametrize("metric,value", [("notes_ms.seq", 0.003),
                                          ("notes_p99_ms.seq", 0.04)])
def test_notes_readers_read_the_span(metric, value):
    read = spec.reader(metric)
    assert read(_run({"notes": (0.0003, 30)}, {"notes": NOTES})) == \
        pytest.approx(value)


@pytest.mark.parametrize("metric", ["notes_ms.seq", "notes_p99_ms.seq"])
def test_notes_readers_give_nothing_without_the_span(metric):
    """A program without the span (a parent, or a window with no note
    block) leaves the metric out of the line, and nothing raises."""
    assert spec.reader(metric)(_run({"commands": (0.004, 100)}, {})) is None
