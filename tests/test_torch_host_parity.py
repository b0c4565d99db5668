"""The port's own copies of the reference's host modules, against the
reference on the same seeded inputs.

libzl_tpu_torch keeps a copy of every JAX-free host module it runs
(constants, timebase, the voice pool, host core binding, scheduler, clip,
MIDI, I/O and profiling modules), so that it imports nothing of the JAX
package. Host code is held bit-equal: the copies' source must parse to the
reference's (docstrings aside; the reworked session models differ only in
the definitions REWORKED names), and the voice pool's program and advance,
the native host core, the scheduler's step ring, WAV round trips, the clip
model's positions, the session update and the profiling counters give the
reference's values exactly. The one tolerance is the reference's own for the native host core
against the numpy advance (exp2 may differ by an ulp between libm and numpy,
tests/test_hostcore.py). Every reference engine or pool here uses the numpy
program builder: no test of the port builds the reference's native/
libraries.
"""

import ast
import copy
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import __graft_entry__ as graft
from libzl_tpu.engine import commands as ref_commands
from libzl_tpu.engine import scheduler as ref_scheduler
from libzl_tpu.engine import voicestate as ref_voicestate
from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.io import wav as ref_wav
from libzl_tpu.models import audio_levels as ref_levels
from libzl_tpu.models import clip as ref_clip
from libzl_tpu.models import positions as ref_positions
from libzl_tpu.ops import voice as ref_voice
from libzl_tpu.utils import profiling as ref_profiling
from libzl_tpu_torch.engine import commands as port_commands
from libzl_tpu_torch.engine import hostcore as port_hostcore
from libzl_tpu_torch.engine import scheduler as port_scheduler
from libzl_tpu_torch.engine import voicestate as port_voicestate
from libzl_tpu_torch.engine.engine import AudioEngine as PortEngine
from libzl_tpu_torch.io import wav as port_wav
from libzl_tpu_torch.models import audio_levels as port_levels
from libzl_tpu_torch.models import clip as port_clip
from libzl_tpu_torch.models import positions as port_positions
from libzl_tpu_torch.models.feedback import FeedbackTable
from libzl_tpu_torch.ops import voice as port_voice
from libzl_tpu_torch.utils import profiling as port_profiling

REPO = Path(__file__).resolve().parent.parent
SR = 48000.0

# modules copied from the reference: the same source as the reference's,
# docstrings aside, but for REWORKED's definitions
VERBATIM = [
    "constants.py", "timebase.py", "engine/commands.py",
    "engine/scheduler.py", "engine/allocator.py", "engine/soundbank.py",
    "engine/recorder.py", "engine/hostcore.py", "midi/messages.py",
    "midi/translations.py", "midi/devices.py", "midi/router.py",
    "midi/transport.py", "models/positions.py", "models/fader.py",
    "models/sampler_map.py", "models/audio_levels.py", "models/clip.py",
    "models/session.py", "ops/stretch_native.py", "io/wav.py", "io/flac.py", "io/codecs.py",
    "io/alsa.py", "io/sinks.py", "io/sources.py",
]


def _tree_without_docstrings(path: Path) -> ast.Module:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return tree


def _source_without_docstrings(path: Path) -> str:
    return ast.dump(_tree_without_docstrings(path))


# copies the port reworked: the reference's module but for these
# definitions (added, changed or gone), which keep the reference's values
# in another form: the session feedback in one table
# (test_session_update_bit_equal); and the clips' render worker, which
# times each render on its clip's engine's profiler (span clip_render) and
# names its thread for the span record
REWORKED = {
    "models/positions.py": ["PlaybackPosition", "PositionsModel"],
    "models/clip.py": ["ClipAudioSource", "LEVEL_DECAY", "LEVEL_THROTTLE_S",
                       "PROGRESS_THROTTLE_S", "_row_field", "_render_worker"],
    "models/audio_levels.py": ["AudioLevels"],
}


def _definitions(path: Path) -> dict:
    """name -> dumped source (docstrings aside) of each top-level function,
    class and assignment of a module; its other statements in order under
    None, imports left out."""
    out, rest = {}, []
    for node in _tree_without_docstrings(path).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        name = getattr(node, "name", None)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
        elif isinstance(node, ast.AnnAssign):
            name = getattr(node.target, "id", None)
        if name is None:
            rest.append(ast.dump(node))
        else:
            out[name] = ast.dump(node)
    out[None] = rest
    return out


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_the_reference_source(rel):
    """A verbatim copy parses to the reference module, docstrings aside,
    and its docstring names the file it copies; a reworked one differs
    from the reference only in the definitions REWORKED names, and its
    docstring names the reference's file."""
    port = REPO / "libzl_tpu_torch" / rel
    ref = REPO / "libzl_tpu" / rel
    doc = ast.get_docstring(ast.parse(port.read_text())).replace("\n", " ")
    if rel in REWORKED:
        got, want = _definitions(port), _definitions(ref)
        assert sorted(k for k in got.keys() | want.keys() if k is not None
                      and got.get(k) != want.get(k)) == sorted(REWORKED[rel])
        assert got[None] == want[None]
        assert f"libzl_tpu/{rel}" in doc
        return
    assert _source_without_docstrings(port) == _source_without_docstrings(
        ref)
    assert f"A copy of libzl_tpu/{rel}" in doc


def _top_level(path: Path) -> dict:
    """name -> dumped source (docstrings aside) of each top-level function
    and statement of a module, the module docstring left out."""
    tree = ast.parse(path.read_text())
    out = {}
    for i, node in enumerate(tree.body[1:], 1):
        name = getattr(node, "name", f"stmt{i}")
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
        out[name] = ast.dump(node)
    return out


def test_resample_copy_differs_only_in_the_stretch_dispatch():
    """ops/resample.py is the reference's but for the accelerator backend:
    `resolve_stretch_backend` maps 'torch' and 'jax' to the torch vocoder
    and `stretch` runs it; every other function is the reference's source."""
    rel = "ops/resample.py"
    port = _top_level(REPO / "libzl_tpu_torch" / rel)
    ref = _top_level(REPO / "libzl_tpu" / rel)
    assert port.keys() == ref.keys()
    changed = sorted(k for k in ref if port[k] != ref[k])
    assert changed == ["resolve_stretch_backend", "stretch"]
    assert "A copy of libzl_tpu/ops/resample.py" in ast.get_docstring(
        ast.parse((REPO / "libzl_tpu_torch" / rel).read_text())).replace(
            "\n", " ")


# ------------------------------------------------- voice pool + host core

STATE = [
    "active", "clip_id", "pos_int", "pos_frac", "rate_int", "rate_frac",
    "istart", "stop", "looping", "beat_quantized", "loop_len_ticks",
    "next_loop_tick", "gain", "clip_volume", "pan", "lane", "stage", "env",
    "a_rate", "d_rate", "sustain", "rel_rate", "inv_rel", "rel_log2",
    "rel_mode", "release_sec", "pending_start", "pending_release",
    "position_id",
]


def _example_pool(pool_cls, monkeypatch, V, B):
    """__graft_entry__._example_inputs' pool (half the voices active, mixed
    looping modes, pitched rates, live envelopes), built from `pool_cls`."""
    with monkeypatch.context() as m:
        m.setattr(ref_voicestate, "VoicePool", pool_cls)
        _, prog, _ = graft._example_inputs(V, B, 1 << 15)
    return prog


def _note_ons(pool, seed):
    """tests/test_hostcore.py's mixed session: random clips, rates, loop
    modes, envelopes and start ticks on all but 8 voices."""
    rng = np.random.default_rng(seed)
    for v in range(pool.num_voices - 8):
        pool.note_on(
            v, clip_id=int(rng.integers(0, 8)),
            midi_note=int(rng.integers(40, 85)),
            midi_channel=int(rng.integers(-2, 10)),
            lane=int(rng.integers(0, 12)),
            base=int(rng.integers(0, 4)) * 512,
            length=int(rng.integers(2000, 40000)),
            source_rate=float(rng.choice([44100.0, 48000.0])),
            root_note=60, start_sec=float(rng.uniform(0, 0.01)),
            stop_sec=float(rng.uniform(0.05, 0.8)),
            gain=float(rng.uniform(0, 1)),
            clip_volume=float(rng.uniform(0, 1)),
            pan=float(rng.uniform(-1, 1)),
            attack=float(rng.choice([0.0, 0.003, 0.05])),
            decay=float(rng.choice([0.0, 0.05, 0.2])),
            sustain=float(rng.uniform(0.1, 1.0)),
            release=float(rng.choice([0.0, 0.02, 0.05])),
            looping=bool(rng.integers(0, 2)),
            length_beats=float(rng.choice([1.0, 2.0, 0.75, 1.3])),
            start_tick=int(rng.integers(0, 96)))


@pytest.mark.parametrize("B", [128, 1024])
def test_example_inputs_program_bit_equal(B, monkeypatch):
    """__graft_entry__._example_inputs through the port's VoicePool: the
    packed program is the reference's, bit for bit."""
    want = ref_voice.pack_program(_example_pool(
        ref_voicestate.VoicePool, monkeypatch, 64, B))
    got = port_voice.pack_program(_example_pool(
        port_voicestate.VoicePool, monkeypatch, 64, B))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32


@pytest.mark.parametrize("host", ["numpy", "native"])
@pytest.mark.parametrize("seed,B,blocks,release_at", [
    (1, 128, 40, None), (2, 128, 60, 5), (5, 1024, 20, 3),
])
def test_voice_pool_session_bit_equal(host, seed, B, blocks, release_at):
    """A scripted session block by block: the reference's numpy
    build_program + advance against the port's copy of them ("numpy", bit
    for bit) and against the port's native host core on its own loader
    ("native": ints bit-equal, floats rtol 1e-6 as tests/test_hostcore.py
    holds the reference's)."""
    if host == "native":
        assert port_hostcore.available()
    ref = ref_voicestate.VoicePool(64, B, SR)
    port = port_voicestate.VoicePool(64, B, SR)
    _note_ons(ref, seed)
    _note_ons(port, seed)
    lanes = np.ones(12, bool)
    lanes[4] = False
    for b in range(blocks):
        if b == release_at:
            for v in range(8):
                ref.note_off(v, tail=True, frame_offset=13)
                port.note_off(v, tail=True, frame_offset=13)
        args = dict(block_start_sample=float(b * B), tick_anchor_sample=0.0,
                    tick_anchor=0, samples_per_tick=250.0)
        prog = ref.build_program(lane_enabled=lanes, **args)
        wi, wf = ref_voice.pack_program(prog)
        died = sorted(ref.advance(prog)["died"].tolist())
        act = np.asarray(prog.active, bool)
        if host == "numpy":
            pprog = port.build_program(lane_enabled=lanes, **args)
            gi, gf = port_voice.pack_program(pprog)
            got_died = sorted(port.advance(pprog)["died"].tolist())
            np.testing.assert_array_equal(gf, wf, err_msg=f"block {b}")
        else:
            gi, gf, info = port_hostcore.voice_update(
                port, lane_enabled=lanes, **args)
            got_died = sorted(v for v, _, _ in info)
            np.testing.assert_allclose(gf[act], wf[act], rtol=1e-6, atol=0,
                                       err_msg=f"block {b}")
        np.testing.assert_array_equal(gi[act], wi[act], err_msg=f"block {b}")
        assert got_died == died
        for name in STATE:
            g, w = getattr(port, name), getattr(ref, name)
            if host == "native" and name in ("env", "rel_rate"):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9,
                                           err_msg=f"{name}, block {b}")
            else:
                np.testing.assert_array_equal(g, w,
                                              err_msg=f"{name}, block {b}")
    assert ref.active.any()


def test_horizon_dynamics_bit_equal():
    """pack_horizon_dynamics, the host half of the compact lookahead
    horizon, on the same programs."""
    pools = [ref_voicestate.VoicePool(32, 128, SR),
             port_voicestate.VoicePool(32, 128, SR)]
    for p in pools:
        _note_ons(p, 9)
    outs = []
    for p, mod in zip(pools, (ref_voice, port_voice)):
        packed = []
        for b in range(6):
            prog = p.build_program(block_start_sample=float(b * 128),
                                   tick_anchor_sample=0.0, tick_anchor=0,
                                   samples_per_tick=250.0)
            packed.append(mod.pack_program(prog))
            p.advance(prog)
        outs.append(mod.pack_horizon_dynamics(packed[1:], p.istart))
    assert outs[0] is not None
    np.testing.assert_array_equal(outs[1], outs[0])


# -------------------------------------------------------------- scheduler


def _steps_as_tuples(steps):
    return [(tuple(e.data for e in s.midi),
             tuple(dataclasses.astuple(c) for c in s.clip_commands),
             tuple(dataclasses.astuple(c) for c in s.timer_commands))
            for s in steps]


def _drive_ring(sched, cmds, seed):
    """A seeded schedule with coalescing clip commands, timer commands and
    MIDI, then a stop-time flush; returns every observable."""
    rng = np.random.default_rng(seed)
    ring = sched.StepRing(64)
    merged = []
    for _ in range(300):
        delay = int(rng.integers(0, 64))
        roll = rng.random()
        if roll < 0.5:
            c = cmds.ClipCommand.channel(int(rng.integers(0, 4)),
                                         int(rng.integers(0, 3)))
            c.midi_note = int(rng.integers(58, 62))
            c.change_volume = bool(rng.integers(0, 2))
            c.volume = float(rng.uniform(0, 1))
            c.start_playback = bool(rng.integers(0, 2))
            c.stop_playback = not c.start_playback
            merged.append(ring.schedule_clip_command(c, delay))
        elif roll < 0.75:
            ring.schedule_timer_command(cmds.TimerCommand(
                operation=cmds.Operation(int(rng.integers(0, 4))),
                parameter=int(rng.integers(0, 100))), delay)
        else:
            status = int(rng.choice([0x80, 0x90]))
            ring.schedule_midi(bytes([status, 60, int(rng.integers(0, 2))]),
                               delay)
        if rng.random() < 0.2:
            merged.append(_steps_as_tuples([ring.pop_next()]))
    offs, zeroed = ring.flush_for_stop()
    return (merged, [e.data for e in offs],
            [dataclasses.astuple(c) for c in zeroed],
            [sched.midi_clock_due(t) for t in range(100)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_ring_bit_equal(seed):
    assert _drive_ring(port_scheduler, port_commands, seed) == _drive_ring(
        ref_scheduler, ref_commands, seed)


# ----------------------------------------------------------------- WAV I/O


@pytest.mark.parametrize("bit_depth", [16, 24, 32])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_bit_equal(tmp_path, bit_depth, channels):
    """Each package writes the same bytes and reads either's file back to
    the same samples."""
    x = np.random.default_rng(bit_depth + channels).uniform(
        -1.2, 1.2, (1000, channels)).astype(np.float32)
    paths = {}
    for name, mod in (("ref", ref_wav), ("port", port_wav)):
        paths[name] = tmp_path / f"{name}.wav"
        mod.write_wav(paths[name], x, 44100, bit_depth=bit_depth)
    assert paths["ref"].read_bytes() == paths["port"].read_bytes()
    for p in paths.values():
        want, got = ref_wav.read_audio(p), port_wav.read_audio(p)
        assert got.sample_rate == want.sample_rate == 44100
        np.testing.assert_array_equal(got.samples, want.samples)
        np.testing.assert_array_equal(port_wav.to_stereo(got.samples),
                                      ref_wav.to_stereo(want.samples))


# --------------------------------------------------------------- the clip


def _clip_observables(clip_mod, data_cls, pos_mod):
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (9000, 2)).astype(
        np.float32)
    clip = clip_mod.ClipAudioSource(None, audio=data_cls(x, 48000))
    try:
        out = [clip.get_duration()]
        clip.set_start_position(0.013)
        clip.set_length(0.75, 133)
        for count in (1, 4, 7):
            clip.set_slices(count)
            out += [(clip.get_start_position(i), clip.get_stop_position(i))
                    for i in range(-1, count + 1)]
            out += [clip.slice_for_midi_note(n) for n in range(50, 75)]
        clip.set_speed_ratio(1.25)
        clip.set_pitch(2.0)
        clip.set_gain(-3.0)
        clip.set_volume(-6.0)
        clip.set_pan(0.3)
        out += [clip.volume_absolute, clip.get_volume_db(), clip.pan]
        playback = clip.playback_audio.samples
    finally:
        clip.destroy()
    now = [0.0]
    model = pos_mod.PositionsModel(clock=lambda: now[0])
    rng = np.random.default_rng(4)
    ids = list(range(10))
    for i in ids:
        model.create_position(i)
    for t in range(5):
        now[0] = 0.01 * t
        model.set_many(ids, rng.uniform(0, 1, 10), rng.uniform(0, 1, 10))
        out += [model.peak_gain(), model.first_progress(), len(model)]
    now[0] = 10.0
    out += [model.cleanup(), len(model)]
    return out, playback


def test_clip_positions_bit_equal(monkeypatch):
    """The clip model's start/stop positions per slice, slice lookup,
    volume and the vocoder playback render (speed, pitch, gain), and the
    positions model under an injected clock."""
    monkeypatch.setenv("LIBZL_TPU_STRETCH", "vocoder")
    want, want_pb = _clip_observables(ref_clip, ref_wav.AudioData,
                                      ref_positions)
    got, got_pb = _clip_observables(port_clip, port_wav.AudioData,
                                    port_positions)
    assert got == want
    np.testing.assert_array_equal(got_pb, want_pb)


# ------------------------------------------------------ the session update

# name -> clips, voices, and what the session does between updates:
# `churn` (a share of voices dies and as many notes start each update),
# `orphans` (positions made through the models' API, never updated, and a
# clock jump past the orphan timeout), `remove` (a clip unregistered, its
# voices left playing, and a clip registered with a position made before),
# `bucket` (voice peaks shorter than the pool, padded), `listen` (listeners
# and callbacks on some clips only)
SESSION_CASES = {
    "one_clip": dict(clips=1, voices=4),
    "clips64_voices96": dict(clips=64, voices=96, listen=(3, 17, 40)),
    "position_count": dict(clips=1, voices=40, listen=(0,)),
    "orphans": dict(clips=4, voices=8, orphans=True, listen=(1,)),
    "listeners_some_clips": dict(clips=8, voices=16, listen=(1, 4, 6)),
    "clip_removed": dict(clips=6, voices=16, remove=True, listen=(2, 3)),
    "bucket_peaks": dict(clips=8, voices=32, bucket=12),
    "notes_churn": dict(clips=8, voices=24, churn=0.3, listen=(0, 5)),
}


def _bits(x):
    """Floats as their bits (hex), through lists, tuples and dicts."""
    if isinstance(x, (list, tuple)):
        return type(x)(_bits(v) for v in x)
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (float, np.floating)):
        return float(x).hex()
    return x


class _SessionSide:
    """One package's clips, meters and the engine state update_session
    reads, under an injected clock."""

    def __init__(self, port: bool, clock):
        self.port, self.clock = port, clock
        self.clip_mod = port_clip if port else ref_clip
        self.wav_mod = port_wav if port else ref_wav
        self.update = (PortEngine if port else RefEngine).update_session
        self.engine = SimpleNamespace(
            clips={}, total_blocks=0, _levels_every=2,
            _last_analyze_block=-(10**9))
        self.engine.levels = (port_levels if port else ref_levels).AudioLevels(
            self.engine)
        if port:
            # small to start with: the session grows both parts
            self.engine.feedback = FeedbackTable(4, clips=2, clock=clock)
        self.all = []      # every clip made, registered or not
        self.fired = []    # (clip index, kind, value) in firing order

    def make_clip(self, audio: np.ndarray) -> None:
        clip = self.clip_mod.ClipAudioSource(
            None, audio=self.wav_mod.AudioData(audio, 48000))
        if self.port:
            clip.positions_model._table.clock = self.clock
        else:
            clip.positions_model._clock = self.clock
        self.all.append(clip)

    def register(self, i: int) -> None:
        clip = self.all[i]
        self.engine.clips[clip.id] = clip
        if self.port:
            self.engine.feedback.attach(clip)

    def unregister(self, i: int) -> None:
        clip = self.all[i]
        del self.engine.clips[clip.id]
        if self.port:
            self.engine.feedback.detach(clip)

    def listen(self, i: int) -> None:
        clip, fired = self.all[i], self.fired
        m = clip.positions_model
        m.on_peak_gain_changed = lambda v: fired.append((i, "peak", v))
        m.on_first_progress_changed = lambda v: fired.append((i, "first", v))
        if i % 2 == 0:
            clip.progress_callback = lambda v: fired.append((i, "progress", v))
        if i % 3 != 1:
            clip.audio_level_callback = lambda v: fired.append((i, "level", v))

    def positions(self, i: int) -> list:
        m = self.all[i].positions_model
        if self.port:
            t = m._table
            return [(pid, t.gain[r], t.progress[r], t.updated[r])
                    for pid, r in m._rows.items()]
        return [(pid, p.gain, p.progress, p.last_updated)
                for pid, p in m._positions.items()]

    def step(self, pool: dict, fetched: dict) -> list:
        ids = np.array([c.id for c in self.all] + [-1])
        self.engine.pool = SimpleNamespace(
            num_voices=pool["active"].size, active=pool["active"],
            clip_id=ids[pool["clip"]], position_id=pool["pid"],
            progress=lambda: pool["progress"])
        before = [{p[0] for p in self.positions(i)}
                  for i in range(len(self.all))]
        self.engine.total_blocks += 1
        self.update(self.engine, SimpleNamespace(outputs=None),
                    include_recorders=False,
                    fetched={k: v.copy() for k, v in fetched.items()})
        out = []
        for i, clip in enumerate(self.all):
            m = clip.positions_model
            pos = self.positions(i)
            out.append(dict(
                positions=pos, reaped=sorted(before[i] - {p[0] for p in pos}),
                peak=m.peak_gain(), first=m.first_progress(), n=len(m),
                level=clip.audio_level, progress=clip._last_progress,
                signal=clip._level_signal,
                due=(clip._next_progress_time, clip._next_level_time)))
        lv = self.engine.levels
        out.append({k: getattr(lv, k) for k in (
            "channels", "channels_a", "channels_b", "channels_rms",
            "playback", "playback_a", "playback_b", "playback_a_hold",
            "playback_b_hold", "capture_a", "capture_b", "recording_a",
            "recording_b")})
        out.append(list(self.fired))
        self.fired.clear()
        return _bits(out)


@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_session_update_bit_equal(case, monkeypatch):
    """The port's session update (one pass over the feedback table) and
    the reference's per-clip loop of update_session over its positions,
    clip and meter models, on the same voices, peaks and clock: every
    position's gain, progress and update time, the reaped ids, each clip's
    peak gain, first progress, level and published progress, the meters,
    and the ordered (clip, kind, value) list of fired listeners and
    callbacks, bit for bit."""
    spec = SESSION_CASES[case]
    rng = np.random.default_rng(sorted(SESSION_CASES).index(case))
    now = [1000.0]
    clock = lambda: now[0]  # noqa: E731
    monkeypatch.setattr(ref_clip, "time", SimpleNamespace(monotonic=clock))
    n_clips, V = spec["clips"], spec["voices"]
    sides = [_SessionSide(port, clock) for port in (False, True)]
    audio = [rng.uniform(-0.5, 0.5, (int(rng.integers(600, 3000)), 2))
             .astype(np.float32) for _ in range(n_clips + 1)]
    for side in sides:
        for a in audio[:n_clips]:
            side.make_clip(a)
        for i in range(n_clips):
            side.register(i)
            if i % 3 == 1:
                side.all[i].set_start_position(0.004 * i)
        for i in spec.get("listen", ()):
            side.listen(i)
    registered = set(range(n_clips))
    pool = dict(active=np.zeros(V, bool), clip=np.full(V, n_clips + 1),
                pid=np.full(V, -1, np.int64), progress=np.zeros(V))
    next_pid = [0]

    def start(v: int) -> None:
        i = int(rng.choice(sorted(registered)))
        pid = next_pid[0]
        next_pid[0] += 1
        pool["active"][v], pool["clip"][v], pool["pid"][v] = True, i, pid
        for side in sides:  # the allocator's create_position
            side.all[i].positions_model.create_position(pid)

    def die(v: int) -> None:
        i, pid = int(pool["clip"][v]), int(pool["pid"][v])
        pool["active"][v], pool["pid"][v] = False, -1
        if i in registered:  # the engine's _release_died
            for side in sides:
                side.all[i].positions_model.remove_position(pid)

    for v in range(V):
        start(v)
    churn = spec.get("churn", 0.0)
    lanes = 12
    played = rng.uniform(0, 1, V)
    loud = rng.uniform(0.05, 1, V)
    for step in range(40):
        now[0] += float(rng.choice([0.004, 0.011, 0.021, 0.033, 0.05]))
        if step in (20, 33):
            now[0] += 1.2  # past the orphan timeout
        if spec.get("orphans"):
            if step in (2, 9):
                for k in range(3):
                    for side in sides:
                        side.all[k % n_clips].positions_model.create_position(
                            10_000 + 10 * step + k)
            if step == 5:
                for side in sides:  # an id made again keeps its place
                    side.all[0].positions_model.create_position(10_020)
                    side.all[1].positions_model.set_gain_and_progress(
                        10_021, 0.375, 0.5)
        if spec.get("remove"):
            if step == 8:
                registered.discard(2)
                for side in sides:
                    side.unregister(2)
            if step == 15:
                for side in sides:
                    side.make_clip(audio[n_clips])
                    side.all[n_clips].positions_model.create_position(999)
                    side.register(n_clips)
                registered.add(n_clips)
            if step == 22:
                for side in sides:
                    side.all[3].set_start_position(0.01)
        for v in range(V):
            if churn and pool["active"][v] and rng.random() < churn:
                die(v)
            elif churn and not pool["active"][v] and rng.random() < churn:
                start(v)
        # playback creeps on by about the progress threshold, or jumps;
        # peaks drift by about the level threshold, or fall silent
        played += rng.uniform(0.0, 0.0022, V)
        jump = rng.random(V) < 0.1
        played[jump] = rng.uniform(0, 1, np.count_nonzero(jump))
        played %= 1.0
        pool["progress"] = np.where(pool["active"], played, 0.0)
        loud *= np.exp(rng.normal(0.0, 0.012, V))
        n_peaks = spec.get("bucket", V)
        peaks = loud[:n_peaks].astype(np.float32)
        peaks[rng.random(n_peaks) < 0.1] = 0.0
        if step % 11 == 10:
            peaks[:] = 0.0  # silence: the levels decay
        fetched = dict(
            lane_peaks=rng.uniform(0, 1.2, (lanes, 2)).astype(np.float32),
            master_peak=rng.uniform(0, 1.2, 2).astype(np.float32),
            lane_rms=rng.uniform(0, 0.8, (lanes, 2)).astype(np.float32),
            voice_peaks=peaks)
        fetched["lane_rms"][rng.random((lanes, 2)) < 0.2] = 0.0
        want, got = (side.step(pool, fetched) for side in sides)
        assert got == want, f"step {step}"
    for side in sides:
        for clip in side.all:
            clip.destroy()


# -------------------------------------------------------------- profiling


def _drive_profiling(mod, seed):
    rng = np.random.default_rng(seed)
    slo = mod.SloCounter(0.0026)
    dsp = mod.DspLoad(0.0026)
    prof = mod.BlockProfiler(window=64)
    dog = mod.EventWatchdog()
    out = []
    kinds = ["block", "emit", "horizon", "adopt", "per_block"]
    for _ in range(400):
        s = float(rng.exponential(0.002))
        bb = int(rng.choice([1, 1, 1, 16]))
        out.append(slo.observe(s, budget_blocks=bb,
                               kind=str(rng.choice(kinds))))
        out.append(dsp.observe(s, budget_blocks=bb))
        prof.record(str(rng.choice(["host", "dispatch"])), s)
        n = int(rng.integers(0, 4))
        out.append(dog.observe_block(n, n - int(rng.random() < 0.05)))
    out += [slo.total_blocks, slo.missed_blocks, slo.worst_overrun,
            slo.miss_rate, slo.last_kind,
            {k: tuple(v) for k, v in slo.by_kind.items()}, dsp.load,
            prof.summary(), dog.check()]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_profiling_counters_bit_equal(seed):
    """SloCounter, DspLoad, BlockProfiler and EventWatchdog on the same
    observations."""
    assert _drive_profiling(port_profiling, seed) == _drive_profiling(
        ref_profiling, seed)


def test_reference_bridge_entry_points_are_copied():
    """Every C entry point of the reference's bridge has a port function
    of the same name, and the runtime-free ones act on the port's clip
    registry."""
    import inspect

    from libzl_tpu.capi import bridge as ref_bridge
    from libzl_tpu_torch.capi import bridge

    want = {n for n, f in vars(ref_bridge).items()
            if inspect.isfunction(f) and f.__module__ == ref_bridge.__name__
            and not n.startswith("_flat")}
    missing = sorted(n for n in want if not callable(getattr(bridge, n, None)))
    assert not missing, missing
    x = np.zeros((4800, 1), np.float32)
    clip = port_clip.ClipAudioSource(None, audio=port_wav.AudioData(x, 48000))
    try:
        assert bridge.clip_by_id(clip.id) is clip
        assert ref_bridge.clip_by_id(clip.id) is not clip
        bridge.clip_set_adsr_attack(clip.id, 0.25)
        assert clip.adsr_attack == bridge.clip_adsr_attack(clip.id) == 0.25
        assert bridge.clip_get_duration(clip.id) == 0.1
    finally:
        clip.destroy()
    assert bridge.clip_by_id(clip.id) is None
    assert bridge.db_from_volume(0.5) == ref_bridge.db_from_volume(0.5)
    assert bridge.timer_get_multiplier() == ref_bridge.timer_get_multiplier()
