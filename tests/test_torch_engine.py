"""The port's AudioEngine end to end on the CPU, against the reference engine.

One scripted session — clips (looping, one-shot, a short loop that wraps
several times per superblock, a panned loop with attack), a sample-accurate
start, a note-off, a mid-walk BPM change, strip changes, stop-all and an idle
stretch — runs through the port's `AudioEngine(device="cpu")`, the reference
`AudioEngine(backend="numpy")` and the reference
`AudioEngine(backend="jax", lookahead=0, voice_buckets="off",
fetch="gather")`, at B=128 and B=1024. Every block's voice peaks are
compared at the render's per-voice tolerance (rtol 2e-6 / atol 1e-9,
tests/test_voice_render.py:214-217); master and lane peaks, which sum voices
into lanes and lanes into the master bus in another order, at rtol 1e-5 /
atol 2e-6 per voice in the densest lane (chip_smoke.py's rule; the script
puts one voice on each lane).
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libzl_tpu.engine import commands as ref_commands
from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.io import wav as ref_wav
from libzl_tpu.models import clip as ref_clip
from libzl_tpu_torch.engine import commands as port_commands
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io import wav as port_wav
from libzl_tpu_torch.models import clip as port_clip

SR = 48000
V = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the per-block path: these tests count one dispatch per rendered block; the
# default engine (lookahead horizon, buckets) has its own tests
# (tests/test_torch_lookahead.py, tests/test_torch_buckets.py)
PER_BLOCK = dict(lookahead=0, voice_buckets="off")
# every reference engine takes the numpy program builder: the reference's
# own tests hold it bit-equal to the native host core (tests/test_hostcore.py)
REF_HOST = dict(host_core="numpy")


def api(engine):
    """(ClipAudioSource, AudioData, commands module) of the engine's own
    package: each engine gets its package's clip and command objects."""
    if isinstance(engine, RefEngine):
        return ref_clip.ClipAudioSource, ref_wav.AudioData, ref_commands
    return port_clip.ClipAudioSource, port_wav.AudioData, port_commands

# (B, blocks, {block: event}) — events land at the same musical places
SCRIPTS = {
    128: (40, {8: "note_off", 12: "bpm", 16: "strips", 24: "stop_all"}),
    1024: (16, {2: "note_off", 3: "bpm", 4: "strips", 8: "stop_all"}),
}


def make_clips(engine):
    clip_cls, data_cls, _ = api(engine)
    clips = []
    for i, (seconds, freq) in enumerate(
            [(0.1, 220.0), (0.03, 330.0), (0.01, 440.0), (0.07, 550.0)]):
        t = np.arange(int(SR * seconds)) / SR
        wave = np.stack([0.4 * np.sin(2 * np.pi * freq * t),
                         0.3 * np.sin(2 * np.pi * 1.01 * freq * t)], axis=1)
        clip = clip_cls(engine, audio=data_cls(wave.astype(np.float32), SR))
        clip.adsr_release = 0.005
        clips.append(clip)
    clips[3].set_pan(0.5)
    clips[3].adsr_attack = 0.002
    return clips


def start_session(engine):
    clips = make_clips(engine)
    ClipCommand = api(engine)[2].ClipCommand
    engine.start_transport(bpm=120)
    clips[0].play(loop=True, midi_channel=0)
    clips[1].play(loop=False, midi_channel=1)
    clips[2].play(loop=True, midi_channel=2)
    cmd = ClipCommand.channel(clips[3].id, 3)   # sample-accurate, 5 ticks in
    cmd.midi_note = 67
    cmd.change_volume = True
    cmd.volume = 0.8
    cmd.looping = True
    cmd.start_playback = True
    engine.schedule_clip_command(cmd, 5)
    return clips


def apply_event(engine, clips, event):
    cmds = api(engine)[2]
    ClipCommand, Operation, TimerCommand = (
        cmds.ClipCommand, cmds.Operation, cmds.TimerCommand)
    if event == "note_off":
        clips[0].stop(0)
    elif event == "bpm":
        engine.schedule_timer_command(
            TimerCommand(operation=Operation.SET_BPM, parameter=140), 0)
    elif event == "strips":
        engine.set_strip(0, dry=0.5, pan=-0.4)
        engine.schedule_timer_command(TimerCommand(
            operation=Operation.PASSTHROUGH_CLIENT,
            parameter=2, parameter2=3, parameter3=60), 0)   # channel 2 pan
    elif event == "stop_all":
        engine.stop_all_clips()
        stop = ClipCommand.channel(clips[3].id, 3)   # the note-67 voice
        stop.midi_note = 67
        stop.stop_playback = True
        engine.schedule_clip_command(stop, 0)


def run_script(engine, B, session=False):
    """Per-block (master, lane_peaks, voice_peaks) as numpy; with `session`
    the engine also feeds its levels/positions every 4th block."""
    blocks, events = SCRIPTS[B]
    clips = start_session(engine)
    out, levels = [], []
    for b in range(blocks):
        if b in events:
            apply_event(engine, clips, events[b])
        res = engine.process_block()
        o = res.outputs
        out.append(tuple(np.asarray(x.numpy() if torch.is_tensor(x) else x)
                         for x in (o.master, o.lane_peaks, o.voice_peaks)))
        if session:
            if b % 4 == 3:
                engine.update_session(res)
                levels.append(list(engine.levels.channels_rms))
            else:
                engine.accumulate_peaks(res)
    return out, levels


def assert_blocks_close(got, want, tag):
    for b, (g, w) in enumerate(zip(got, want)):
        for name, gi, wi in zip(("master", "lane_peaks", "voice_peaks"), g, w):
            if name == "voice_peaks":
                np.testing.assert_allclose(gi, wi, rtol=2e-6, atol=1e-9,
                                           err_msg=f"{tag} block {b} {name}")
            else:
                np.testing.assert_allclose(gi, wi, rtol=1e-5, atol=2e-6,
                                           err_msg=f"{tag} block {b} {name}")


def test_session_update_counters():
    """stats()' session_updates counts update_session's passes and
    session_clip_visits the clips that entered Python in them: none without
    callbacks; with a callback on two clips (one kind each) one a callback
    fired; and one more for a clip whose orphaned position is reaped."""
    engine = AudioEngine("cpu", block_frames=128, num_voices=V, **PER_BLOCK)
    now = [100.0]
    engine.feedback.clock = lambda: now[0]
    clips = start_session(engine)

    def updates(n):
        for _ in range(n):
            now[0] += 0.05
            engine.update_session(engine.process_block())
        s = engine.stats()
        return s["session_updates"], s["session_clip_visits"]

    assert updates(12) == (12, 0)
    fired = []
    clips[0].progress_callback = lambda v: fired.append(("progress", v))
    clips[1].audio_level_callback = lambda v: fired.append(("level", v))
    assert updates(12) == (24, len(fired))
    assert {kind for kind, _ in fired} == {"progress", "level"}
    clips[3].positions_model.create_position(10**6)
    before = len(fired)
    now[0] += 1.5
    n, visits = updates(1)
    assert 10**6 not in clips[3].positions_model._rows
    assert (n, visits) == (25, len(fired) + 1)
    assert len(fired) > before


@pytest.mark.parametrize("B,host_core", [(128, "auto"), (1024, "auto"),
                                         (128, "numpy")])
def test_engine_matches_reference_numpy_and_jax(B, host_core):
    """host_core "auto" takes the native host core (built with g++);
    "numpy" the reference's numpy program builder and advance."""
    port = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                       host_core=host_core, **PER_BLOCK)
    assert port.fetch == "gather"
    assert port.use_native_host == (host_core == "auto")
    got, got_levels = run_script(port, B, session=True)
    ref_np = RefEngine(sample_rate=SR, block_frames=B, num_voices=V,
                       backend="numpy", **REF_HOST)
    want_np, want_levels = run_script(ref_np, B, session=True)
    ref_jax = RefEngine(sample_rate=SR, block_frames=B, num_voices=V,
                        backend="jax", lookahead=0, voice_buckets="off",
                        fetch="gather", **REF_HOST)
    want_jax, _ = run_script(ref_jax, B)
    assert_blocks_close(got, want_np, "numpy")
    assert_blocks_close(got, want_jax, "jax")
    np.testing.assert_allclose(got_levels, want_levels, rtol=1e-5, atol=1e-4)
    # the script plays, goes silent after stop-all, and idles at the end
    blocks, events = SCRIPTS[B]
    assert np.abs(got[1][0]).max() > 0.05
    assert np.abs(got[-1][0]).max() == 0.0
    assert port.fetch_dispatches["gather"] < blocks
    assert port.fetch_dispatches["windows"] == 0
    assert port.period_bpm == ref_np.period_bpm
    assert port.total_blocks == blocks


@pytest.mark.parametrize("B", [128, 1024])
def test_windows_fetch_engine_on_cpu(B):
    """fetch="windows" on the CPU renders through the plain windows fetch
    (planar bank, region tail guard) and agrees with the gather engine."""
    gather = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                         **PER_BLOCK)
    windows = AudioEngine("cpu", sample_rate=SR, block_frames=B,
                          num_voices=V, fetch="windows", **PER_BLOCK)
    got, _ = run_script(windows, B)
    want, _ = run_script(gather, B)
    for b, (g, w) in enumerate(zip(got, want)):
        for gi, wi in zip(g, w):
            np.testing.assert_allclose(gi, wi, atol=2e-6, err_msg=f"block {b}")
    assert windows._sound_data_for_backend()[
        windows.mesh.devices[0]].shape[0] == 2                  # planar
    assert gather._sound_data_for_backend()[
        gather.mesh.devices[0]].shape[1] == 2                   # interleaved
    assert windows.fetch_dispatches["gather"] == 0
    assert windows.fetch_dispatches["windows"] == \
        gather.fetch_dispatches["gather"] > 0


def test_over_envelope_pitch_dispatches_gather():
    """A pitch ratio beyond max_pitch_ratio routes the block through the
    gather fetch, like the reference's ratio rule."""
    B = 128
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      fetch="windows", max_pitch_ratio=2.0, **PER_BLOCK)
    ref = RefEngine(sample_rate=SR, block_frames=B, num_voices=V,
                    backend="numpy", max_pitch_ratio=2.0, **REF_HOST)
    outs = []
    for e in (eng, ref):
        clip = make_clips(e)[0]
        cmd = api(e)[2].ClipCommand.channel(clip.id, 0)
        cmd.midi_note = 60 + 19        # ratio ~3.0 > 2.0
        cmd.change_volume = True
        cmd.volume = 1.0
        cmd.looping = True
        cmd.start_playback = True
        e.schedule_clip_command(cmd, 0)
        outs.append([np.asarray(torch.as_tensor(e.process_block()
                                                .outputs.master))
                     for _ in range(4)])
    assert eng.fetch_dispatches == {"windows": 0, "gather": 4}
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=2e-6)


def test_int16_bank_matches_reference():
    B = 128
    port = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                       bank_dtype="int16")
    ref = RefEngine(sample_rate=SR, block_frames=B, num_voices=V,
                    backend="numpy", bank_dtype="int16", **REF_HOST)
    got, _ = run_script(port, B)
    want, _ = run_script(ref, B)
    assert port._sound_data_for_backend()[
        port.mesh.devices[0]].dtype == torch.int16
    assert_blocks_close(got, want, "int16")


def test_convert_matches_reference_state():
    """convert's tensors are the reference engine's own device state: the
    int16-quantized interleaved bank of the numpy backend, the fused
    program, the packed strips."""
    from libzl_tpu.ops.voice import fuse_packed, pack_program, pack_strips
    from libzl_tpu_torch import convert

    ref = RefEngine(sample_rate=SR, block_frames=128, num_voices=V,
                    backend="numpy", bank_dtype="int16", **REF_HOST)
    start_session(ref)
    ref.process_block()
    bank = convert.sound_bank_tensor(ref.bank.data, "cpu", "int16",
                                     "interleaved")
    np.testing.assert_array_equal(bank.numpy(),
                                  ref._sound_data_for_backend())
    planar = convert.sound_bank_tensor(ref.bank.data, "cpu")
    np.testing.assert_array_equal(planar.numpy(), ref.bank.data)
    assert planar.data_ptr() != ref.bank.data.ctypes.data   # a copy
    prog = ref.pool.build_program(
        block_start_sample=float(ref.clock.sample_position),
        tick_anchor_sample=ref.clock.anchor_sample,
        tick_anchor=ref.clock.anchor_tick,
        samples_per_tick=ref.clock.samples_per_tick)
    pi, pf = pack_program(prog)
    np.testing.assert_array_equal(
        convert.upload(fuse_packed(pi, pf), "cpu").numpy(),
        fuse_packed(pi, pf))
    np.testing.assert_array_equal(
        convert.strips_tensor(ref.strips, "cpu").numpy(),
        pack_strips(ref.strips))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        AudioEngine("cuda", num_voices=8)


@pytest.mark.parametrize("device,current,entered", [
    ("cpu", None, False), ("cuda", 0, False), ("cuda:0", 0, False),
    ("cuda:1", 0, True)])
def test_on_device_enters_only_another_card(monkeypatch, device, current,
                                            entered):
    """The one device-entry helper (device.on_device) enters a card only
    where it is not the calling thread's current device: a null context on
    the CPU (which reads no current card), for "cuda" without an index and
    on the current card."""
    from libzl_tpu_torch.device import on_device

    def current_device():
        assert current is not None, "the CPU read the current card"
        return current

    entries = []

    @contextlib.contextmanager
    def enter(dev):
        entries.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", current_device)
    monkeypatch.setattr(torch.cuda, "device", enter)
    ctx = on_device(torch.device(device))
    with ctx:
        pass
    assert entries == ([torch.device(device)] if entered else [])
    assert isinstance(ctx, contextlib.nullcontext) is not entered


@pytest.mark.parametrize("kw", [{"mesh": object()}])
def test_unported_options_are_rejected(kw):
    """A mesh is the port's own (parallel/sharding.Mesh): anything else, a
    jax Mesh included, is rejected at construction."""
    with pytest.raises(ValueError, match="make_mesh"):
        AudioEngine("cpu", num_voices=8, **kw)


@pytest.mark.parametrize("B,V,kw", [
    (128, 1024, {}), (1024, 1024, {}), (4096, 16, {}),
    (128, 16, {"lookahead": 16}), (128, 16, {"lookahead": 1}),
    (128, 128, {"voice_buckets": "auto"}), (128, 128, {"voice_buckets": "off"}),
    (128, 64, {}), (128, 16, {"fetch": "windows"}),
    (128, 16, {"fetch": "windows", "max_pitch_ratio": 2.0}),
])
def test_options_resolve_as_the_reference(B, V, kw):
    """lookahead and voice_buckets (defaults "auto") resolve to what the
    reference's jax engine resolves them to, and so does the fetch, its
    suffix dropped."""
    port = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                       **kw)
    ref = RefEngine(sample_rate=SR, block_frames=B, num_voices=V,
                    backend="jax", **REF_HOST, **kw)
    assert port._lookahead == ref._lookahead
    assert port._bucket_ladder == ref._bucket_ladder
    assert port.fetch == ("windows" if ref.fetch.startswith("windows")
                          else "gather")


def test_default_engine_resolution():
    assert AudioEngine("cpu", block_frames=128)._lookahead == 16
    assert AudioEngine("cpu", block_frames=1024)._lookahead == 2
    assert AudioEngine("cpu", block_frames=4096, num_voices=16)._lookahead == 0
    eng = AudioEngine("cpu", num_voices=1024)
    assert eng._bucket_ladder == [64, 128, 256, 512, 1024]
    for kw in ({"voice_buckets": "banana"}, {"lookahead": "soon"}):
        with pytest.raises(ValueError):
            AudioEngine("cpu", num_voices=16, **kw)


@pytest.mark.parametrize("B", [128, 256, 1024])
def test_cpu_engine_never_reads_the_card_rule(monkeypatch, B):
    """"auto" on the CPU is the reference's rule: the card's measured rule
    (engine._card_lookahead) is not consulted, at the card's measured
    block sizes too."""
    from libzl_tpu_torch.engine import engine as engine_mod

    def card_rule(block_frames):
        raise AssertionError("the CPU engine read the card's rule")

    monkeypatch.setattr(engine_mod, "_card_lookahead", card_rule)
    eng = AudioEngine("cpu", block_frames=B, num_voices=16)
    assert eng._lookahead == min(16, 2048 // B)


def test_bad_options_are_rejected():
    with pytest.raises(ValueError):
        AudioEngine("cpu", num_voices=8, fetch="windows:g4")
    with pytest.raises(ValueError):
        AudioEngine("cpu", num_voices=8, fetch="scatter")
    with pytest.raises(ValueError):
        AudioEngine("cpu", num_voices=8, bank_dtype="float16")
    with pytest.raises(ValueError):
        AudioEngine("meta", num_voices=8)


def test_lazy_top_level_api():
    """The reference's six lazy top-level names (libzl_tpu/__init__.py),
    each from the port's own module."""
    import libzl_tpu_torch
    from libzl_tpu_torch.models import session
    from libzl_tpu_torch.models.waveform import WaveFormItem
    from libzl_tpu_torch.parallel import sharding

    assert libzl_tpu_torch.AudioEngine is AudioEngine
    assert libzl_tpu_torch.ClipAudioSource is port_clip.ClipAudioSource
    assert libzl_tpu_torch.WaveFormItem is WaveFormItem
    assert libzl_tpu_torch.save_session is session.save_session
    assert libzl_tpu_torch.load_session is session.load_session
    assert libzl_tpu_torch.make_mesh is sharding.make_mesh
    with pytest.raises(AttributeError):
        libzl_tpu_torch.render_everything


def test_port_never_imports_jax():
    """Every module of the port (the package walked) and chip_smoke load
    without JAX and without any module of the JAX package `libzl_tpu`, and a
    default engine runs a horizon and adopts its speculative successor
    without loading either (the spec workers included), as does a bridge
    session of 40 blocks — a subprocess: this test process has both loaded
    by tests/conftest.py."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import libzl_tpu_torch\n"
        "for m in pkgutil.walk_packages(libzl_tpu_torch.__path__,\n"
        "                               'libzl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "def loaded():\n"
        "    return sorted(m for m in sys.modules\n"
        "                  if m.split('.')[0] in ('jax', 'libzl_tpu'))\n"
        "assert not loaded(), loaded()\n"
        "from libzl_tpu_torch.engine.engine import AudioEngine\n"
        "e = AudioEngine('cpu', num_voices=16, block_frames=128)\n"
        "assert e._lookahead == 16\n"
        "chip_smoke.build_session(e, num_voices=16, num_clips=2)\n"
        "e.warmup()\n"
        "for _ in range(40):\n"
        "    e.update_session(e.process_block())\n"
        "kinds = e.stats()['slo_by_kind']\n"
        "assert kinds['horizon'][1] >= 1 and kinds['adopt'][1] >= 1, kinds\n"
        "assert e.stats()['spec_failures'] == 0\n"
        "from libzl_tpu_torch.capi import bridge\n"
        "bridge.init_engine(num_voices=16, device='cpu', pump=False)\n"
        "bridge.timer_start(120)\n"
        "bridge._rt().step_blocks(40)\n"
        "assert bridge._rt().engine.total_blocks == 40\n"
        "bridge.shutdown_engine()\n"
        "assert not loaded(), loaded()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
