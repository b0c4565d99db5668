"""The port's C ABI bridge (libzl_tpu_torch/capi/bridge.py) on the CPU.

The groups of tests/test_bridge_api.py and the pump/drain tests of
tests/test_capi.py, driven through the port's bridge with
LIBZL_TPU_BACKEND=cpu, plus what is the port's own: the device variable's
parse, the contract that every host consumer receives numpy float32 (on the
card a tensor there would crash the sink or record silence), and the same
session through the reference bridge and the port's, whose sink streams
agree within the bus tolerance (rtol 1e-5, atol 2e-6 x the voices in the
densest lane; chip_smoke.py's rule).
"""

import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.io.sinks import AudioSink, NullSink
from libzl_tpu_torch.io.wav import AudioData, read_wav, write_wav
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.capi import bridge
from libzl_tpu_torch.capi.bridge import EngineRuntime

SR = 48000
MIX_RTOL = 1e-5
MIX_ATOL_PER_VOICE = 2e-6


class CaptureSink(AudioSink):
    pacing = False

    def __init__(self):
        self.blocks = []
        self._wlock = threading.Lock()

    def write(self, block):
        with self._wlock:
            self.blocks.append(np.array(block))

    def stream(self):
        return np.concatenate(self.blocks, axis=0)


@pytest.fixture
def rt(monkeypatch):
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "cpu")
    monkeypatch.setenv("LIBZL_TPU_VOICES", "32")
    monkeypatch.setenv("LIBZL_TPU_NO_PUMP", "1")
    bridge.init_engine()
    yield bridge._rt()
    bridge.shutdown_engine()


def _make_clip(mod, tmp_path, seconds=0.5, name="clip.wav", freq=220.0):
    t = np.arange(int(SR * seconds)) / SR
    path = tmp_path / name
    write_wav(path, (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32),
              SR)
    return mod.clip_new(str(path))


def _ramp(n=SR):
    return (np.arange(1, n + 1, dtype=np.float32) / n * 0.5)[:, None]


def _start_ramp(rt, ramp):
    clip = ClipAudioSource(rt.engine, audio=AudioData(ramp, SR))
    rt.engine.start_transport(bpm=120)
    cmd = ClipCommand.channel(clip.id, 0)
    cmd.midi_note = 60
    cmd.change_volume = True
    cmd.volume = 1.0
    cmd.start_playback = True
    rt.engine.schedule_clip_command(cmd, 0)
    return clip


def _pump_by_hand(rt, n):
    """The wall-clock pump's sequence without its clock: stage each block
    right after its render, consume it at once."""
    for _ in range(n):
        with rt._lock:
            res = rt.engine.process_block()
            bno = rt.engine.total_blocks
            staged = rt._stage(bno, res)
        rt._consume(bno, res, staged)


# ----------------------------------------------------------- lifecycle


def test_rt_before_init_raises():
    assert bridge._runtime is None
    with pytest.raises(RuntimeError):
        bridge._rt()


@pytest.mark.parametrize("value,device", [
    ("cpu", "cpu"), (" cpu ", "cpu"), ("cuda", "cuda"), ("cuda:1", "cuda:1"),
    ("", "cuda"),
])
def test_backend_env_parse(monkeypatch, value, device):
    monkeypatch.setenv("LIBZL_TPU_BACKEND", value)
    assert bridge.device_from_env() == device


@pytest.mark.parametrize("value", ["auto", "numpy", "jax", "cdua", "cuda:",
                                   "gpu", "cuda:x"])
def test_backend_env_rejects_other_values(monkeypatch, value):
    monkeypatch.setenv("LIBZL_TPU_BACKEND", value)
    monkeypatch.setenv("LIBZL_TPU_NO_PUMP", "1")
    with pytest.raises(ValueError, match="LIBZL_TPU_BACKEND"):
        bridge.init_engine()
    assert bridge._runtime is None


def test_backend_unset_means_cuda(monkeypatch):
    """Unset, the bridge asks for the card; without one that raises (no
    runtime is published, nothing lands on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("LIBZL_TPU_BACKEND", raising=False)
    monkeypatch.setenv("LIBZL_TPU_NO_PUMP", "1")
    with pytest.raises(RuntimeError, match="is_available"):
        bridge.init_engine(num_voices=8)
    assert bridge._runtime is None


def test_init_engine_env_knobs(monkeypatch):
    for k, v in dict(LIBZL_TPU_BACKEND="cpu", LIBZL_TPU_VOICES="32",
                     LIBZL_TPU_NO_PUMP="1", LIBZL_TPU_RATE="44100",
                     LIBZL_TPU_BLOCK="256", LIBZL_TPU_PIPELINE="3",
                     LIBZL_TPU_BOUNCE_DRAIN="4",
                     LIBZL_TPU_LOOKAHEAD="0").items():
        monkeypatch.setenv(k, v)
    try:
        bridge.init_engine()
        rt = bridge._rt()
        assert rt.engine.device.type == "cpu"
        assert rt.engine.sample_rate == 44100
        assert rt.engine.block_frames == 256
        assert rt.pipeline_depth == 3
        assert rt.bounce_drain_blocks == 4
        assert rt.engine._lookahead == 0
        assert rt.engine.pool.num_voices == 32
        assert rt._pump is None
    finally:
        bridge.shutdown_engine()


def test_bounce_drain_auto_by_device():
    assert EngineRuntime(device="cpu", num_voices=8).bounce_drain_blocks == 1
    assert EngineRuntime(device="cpu", num_voices=8,
                         bounce_drain=32).bounce_drain_blocks == 32


def test_quirk_gain_env(monkeypatch):
    for k, v in dict(LIBZL_TPU_BACKEND="cpu", LIBZL_TPU_VOICES="8",
                     LIBZL_TPU_NO_PUMP="1", LIBZL_TPU_QUIRK_GAIN="1").items():
        monkeypatch.setenv(k, v)
    try:
        bridge.init_engine()
        assert bridge._rt().engine.quirk_gain is True
    finally:
        bridge.shutdown_engine()


def test_init_engine_bad_source_spec_does_not_publish(monkeypatch):
    for k, v in dict(LIBZL_TPU_BACKEND="cpu", LIBZL_TPU_VOICES="8",
                     LIBZL_TPU_NO_PUMP="1", LIBZL_TPU_SINK="null",
                     LIBZL_TPU_SOURCE="bogus-kind").items():
        monkeypatch.setenv(k, v)
    try:
        with pytest.raises(ValueError, match="source spec"):
            bridge.init_engine()
        assert bridge._runtime is None
        monkeypatch.delenv("LIBZL_TPU_SOURCE")
        bridge.init_engine()
        assert isinstance(bridge._rt().sink, NullSink)
    finally:
        bridge.shutdown_engine()


def test_shutdown_clears_clip_registry(rt, tmp_path):
    from libzl_tpu_torch.models import clip as clip_mod

    cid = _make_clip(bridge, tmp_path)
    assert clip_mod._registry.get(cid) is not None
    bridge.shutdown_engine()
    assert not clip_mod._registry
    assert bridge._runtime is None
    bridge.init_engine()   # the fixture's teardown shuts this one down


# -------------------------------------------------------- entry points


def test_clip_property_plumbing(rt, tmp_path):
    cid = _make_clip(bridge, tmp_path)
    clip = bridge.clip_by_id(cid)
    assert clip.engine is rt.engine

    assert bridge.clip_get_duration(cid) == pytest.approx(0.5, abs=1e-3)
    assert bridge.clip_get_filename(cid) == "clip.wav"
    bridge.clip_set_start_position(cid, 0.1)
    assert clip.get_start_position() == pytest.approx(0.1)
    bridge.clip_set_length(cid, 0.5, 120)  # half a beat at 120 BPM = 0.25 s
    assert clip.get_stop_position() == pytest.approx(0.35)
    bridge.clip_set_pan(cid, 0.5)
    assert clip.pan == pytest.approx(0.5)
    bridge.clip_set_volume(cid, -6.0)
    assert clip.get_volume_db() == pytest.approx(-6.0)
    bridge.clip_set_slices(cid, 4)
    assert clip.slices == 4
    bridge.clip_set_keyzone_start(cid, 40)
    bridge.clip_set_keyzone_end(cid, 80)
    bridge.clip_set_root_note(cid, 64)
    assert bridge.clip_keyzone_start(cid) == 40
    assert bridge.clip_keyzone_end(cid) == 80
    assert bridge.clip_root_note(cid) == 64
    for name, v in (("attack", 0.01), ("decay", 0.02), ("sustain", 0.6),
                    ("release", 0.09)):
        getattr(bridge, f"clip_set_adsr_{name}")(cid, v)
        assert getattr(bridge, f"clip_adsr_{name}")(cid) == pytest.approx(v)


def test_clip_deferred_render_setters(rt, tmp_path):
    """speed/pitch/gain/crossfade route to the deferred offline re-render
    and land at a block boundary."""
    cid = _make_clip(bridge, tmp_path)
    clip = bridge.clip_by_id(cid)
    before = clip.playback_audio.num_frames
    bridge.clip_set_speed_ratio(cid, 2.0)
    bridge.clip_set_pitch(cid, 3.0)
    bridge.clip_set_gain(cid, -3.0)
    bridge.clip_set_loop_crossfade(cid, 0.01)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        rt.step_blocks(1)
        if clip.playback_audio.num_frames != before:
            break
        time.sleep(0.005)
    assert clip.speed_ratio == pytest.approx(2.0)
    assert clip.pitch_change == pytest.approx(3.0)
    assert clip.gain_db == pytest.approx(-3.0)
    assert clip.playback_audio.num_frames == pytest.approx(before / 2,
                                                           rel=0.05)


def test_clip_callbacks_via_ctypes_pointers(rt, tmp_path):
    cid = _make_clip(bridge, tmp_path, seconds=1.0)
    progress, levels = [], []
    prog_cb = bridge._PROGRESS_CB(lambda v: progress.append(v))
    lvl_cb = bridge._LEVEL_CB(lambda v: levels.append(v))
    bridge.clip_set_progress_callback(
        cid, ctypes.cast(prog_cb, ctypes.c_void_p).value)
    bridge.clip_set_audio_level_callback(
        cid, ctypes.cast(lvl_cb, ctypes.c_void_p).value)
    bridge.timer_start(120)
    bridge.clip_play(cid, True, 2)
    rt.step_blocks(4 * rt.engine._levels_every)
    clip = bridge.clip_by_id(cid)
    clip.sync_progress(now=1e9)
    clip.sync_audio_level(now=1e9)
    bridge.clip_stop(cid, 2)
    assert progress and 0.0 <= progress[-1] <= clip.get_duration()
    assert levels and -200.0 < levels[-1] < 6.0


def test_timer_group(rt, tmp_path):
    from libzl_tpu_torch.constants import BEAT_SUBDIVISIONS, TICKS_PER_BAR

    assert bridge.timer_get_multiplier() == BEAT_SUBDIVISIONS
    ticks = []
    timer_cb = bridge._TIMER_CB(lambda t: ticks.append(t))
    ptr = ctypes.cast(timer_cb, ctypes.c_void_p).value
    bridge.timer_register_callback(ptr)
    bridge.timer_start(120)
    assert rt.engine.transport_running
    assert rt.engine.bpm == pytest.approx(120.0)
    bridge.timer_set_bpm(150.0)
    assert rt.engine.bpm == pytest.approx(150.0)
    rt.step_blocks(int(1.7 * SR / rt.engine.block_frames))
    assert ticks and all(0 <= t < TICKS_PER_BAR for t in ticks)
    fired = len(ticks)
    bridge.timer_deregister_callback(ptr)
    rt.step_blocks(8)
    assert len(ticks) == fired, "callback fired after deregistration"
    cid = _make_clip(bridge, tmp_path)
    bridge.timer_queue_clip_to_start(cid, 2)
    bridge.timer_queue_clip_to_stop(cid, 2)
    bridge.timer_stop()
    assert not rt.engine.transport_running


def test_levels_port_recording_group(rt, tmp_path):
    cid = _make_clip(bridge, tmp_path)
    bridge.levels_set_record_ports_filename_prefix(str(tmp_path / "ports.wav"))
    bridge.levels_add_record_port("master", 0)
    bridge.levels_add_record_port("lane:4", 1)   # channel 2 -> lane 4
    bridge.levels_set_should_record_ports(True)
    assert not bridge.levels_is_recording()
    bridge.levels_start_recording()
    assert bridge.levels_is_recording()
    bridge.timer_start(120)
    bridge.clip_play(cid, True, 2)
    rt.step_blocks(40)
    bridge.levels_stop_recording()
    assert not bridge.levels_is_recording()
    rec = read_wav(tmp_path / "ports.wav").samples
    assert rec.shape == (40 * 128, 2)
    # both ports carry the clip: the port recording is not silent
    assert np.abs(rec[:, 0]).max() > 0.01 and np.abs(rec[:, 1]).max() > 0.01
    bridge.levels_remove_record_port("master", 0)
    bridge.levels_clear_record_ports()
    bridge.levels_set_should_record_ports(False)
    assert not rt.engine.levels.record_ports


def test_passthrough_and_misc(rt, tmp_path):
    for key, value in (("dry", 0.7), ("wet1", 0.3), ("wet2", 0.2),
                       ("pan", -0.5), ("muted", 1.0)):
        bridge.passthrough_set(3, key, value)
        assert bridge.passthrough_get(3, key) == pytest.approx(value)
    bridge.passthrough_set(-1, "dry", 0.9)
    assert bridge.passthrough_get(-1, "dry") == pytest.approx(0.9)
    with pytest.raises(KeyError):
        bridge.passthrough_set(3, "nonsense", 1.0)
    assert bridge.db_from_volume(1.0) == pytest.approx(0.0)
    assert bridge.db_from_volume(0.0) <= -100.0
    cid = _make_clip(bridge, tmp_path)
    bridge.clip_play(cid, True, 2)
    bridge.stop_clips([cid, 999999])
    with pytest.raises(KeyError):
        bridge._clip(424242)
    bridge.clip_destroy(cid)
    assert bridge.clip_by_id(cid) is None


def test_reload_configuration_env(rt, monkeypatch):
    from libzl_tpu_torch.midi.router import Destination

    monkeypatch.setenv("ZYNTHIAN_MIDI_FILTER_OUTPUT", "1")
    bridge.reload_zynthian_configuration()
    router = rt.engine.router
    assert router.filter_midi_out
    router.set_channel_destination(0, Destination.SAMPLER)
    bridge.reload_zynthian_configuration()
    assert router.outputs[0].destination == Destination.SAMPLER


# ---------------------------------------------------------------- pump


def test_pump_survives_failing_sink():
    class BoomSink(AudioSink):
        def __init__(self):
            self.calls = 0

        def write(self, block):
            self.calls += 1
            raise RuntimeError("boom")

    class CountSink(AudioSink):
        def __init__(self):
            self.blocks = 0

        def write(self, block):
            self.blocks += 1

    rt = EngineRuntime(device="cpu", num_voices=16)
    boom = BoomSink()
    rt.set_sink(boom)
    rt.start_pump()
    try:
        deadline = time.monotonic() + 5.0
        while boom.calls == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert boom.calls > 0
        assert isinstance(rt.pump_error, RuntimeError)
        assert rt._running
        good = CountSink()
        rt.set_sink(good)
        deadline = time.monotonic() + 5.0
        while good.blocks == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert good.blocks > 0
    finally:
        rt.stop_pump()
        rt.set_sink(None)
    assert rt._pump is None


def test_phase_stats_and_profile(rt):
    rt._phase("render", 0.0021)
    rt._phase("render", 0.0009)
    rt._phase("copy_wait", 0.0005)
    stats = rt.phase_stats()
    assert stats["render_ms"] == 3.0 and stats["render_n"] == 2
    assert stats["copy_wait_ms"] == 0.5 and stats["copy_wait_n"] == 1
    # the staging ring's two counts are no span: no "_ms" key a reader of
    # the spans' totals would take for one
    ring = {"stage_ring_blocks", "stage_ring_fallbacks"}
    assert {k: stats[k] for k in ring} == dict.fromkeys(ring, 0)
    assert all(k.endswith(("_ms", "_n")) for k in set(stats) - ring)
    summary = rt.profiler.summary()
    assert summary["render"]["max_ms"] == pytest.approx(2.1)
    assert summary["copy_wait"]["count"] == 1


def test_step_blocks_refused_while_pump_runs():
    rt = EngineRuntime(device="cpu", num_voices=16)
    rt.start_pump()
    try:
        with pytest.raises(RuntimeError, match="requires the pump"):
            rt.step_blocks(1)
    finally:
        rt.stop_pump()


def test_set_source_retires_old_source_under_pump():
    class FakeSource:
        def __init__(self):
            self.closed = 0

        def read(self, frames):
            return np.zeros((frames, 2), np.float32)

        def close(self):
            self.closed += 1

    rt = EngineRuntime(device="cpu", num_voices=16)
    first, second = FakeSource(), FakeSource()
    rt.set_source(first)
    rt.start_pump()
    try:
        rt.set_source(second)
        deadline = time.monotonic() + 5.0
        while first.closed == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert first.closed == 1
        assert second.closed == 0
    finally:
        rt.stop_pump()
        rt.set_source(None)


def test_run_ahead_covers_lookahead_budget():
    rt = EngineRuntime(device="cpu", num_voices=16)
    assert rt.engine._lookahead == 16
    assert rt.run_ahead_blocks() >= rt.engine._lookahead + 2
    assert EngineRuntime(device="cpu", num_voices=16,
                         lookahead=0).run_ahead_blocks() >= 4


@pytest.mark.parametrize("depth", [1, 3])
def test_pump_block_sequence_integrity(tmp_path, monkeypatch, depth):
    """The pipelined wall-clock pump must deliver every rendered block to
    the recorder exactly once, in order, including the drained final
    blocks: a recorded linear ramp is a contiguous prefix of the source iff
    no block was dropped, duplicated or reordered."""
    n = SR * 2
    ramp = _ramp(n)
    src, rec = tmp_path / "ramp.wav", tmp_path / "rec.wav"
    write_wav(src, ramp, SR)
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "cpu")
    monkeypatch.setenv("LIBZL_TPU_VOICES", "32")
    monkeypatch.setenv("LIBZL_TPU_PIPELINE", str(depth))
    monkeypatch.delenv("LIBZL_TPU_NO_PUMP", raising=False)
    try:
        bridge.init_engine(pump=True)
        assert bridge._rt().pipeline_depth == depth
        cid = bridge.clip_new(str(src))
        bridge.levels_set_record_global_playback(True)
        bridge.levels_set_global_playback_filename_prefix(str(rec))
        bridge.levels_start_recording()
        bridge.clip_play(cid, False, 0)  # one-shot at root: ratio 1.0
        engine = bridge._rt().engine
        target = engine.total_blocks + 60
        deadline = time.monotonic() + 20.0
        while engine.total_blocks < target and time.monotonic() < deadline:
            time.sleep(0.05)
        bridge.levels_stop_recording()
        assert bridge._rt().pump_error is None
    finally:
        bridge.shutdown_engine()
    x = read_wav(rec).samples[:, 0]
    nz = np.flatnonzero(np.abs(x) > 0)
    assert nz.size > 1280, "too little audio recorded to judge"
    seg = x[nz[0]: nz[-1] + 1]
    # align via a mid-segment sample (mono renders at 0.5x, the M/S pan
    # convention; the first ramp samples record as 16-bit zeros)
    k = int(round(seg[1000] / 0.5 * n / 0.5)) - 1001
    assert 0 <= k < 64, f"head offset {k} outside quantization slack"
    expect = 0.5 * ramp[k: k + len(seg), 0]
    err = float(np.abs(seg - expect).max())
    assert err < 3.1e-5, f"block sequence broken (max dev {err})"


# ---------------------------------------------------------- bounce drain


def _drain_run(drain, blocks=100, record_at=None, tmp_path=None):
    rt = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=drain)
    sink = CaptureSink()
    rt.set_sink(sink)
    _start_ramp(rt, _ramp())
    if record_at is None:
        rt.step_blocks(blocks)
    else:
        rt.step_blocks(record_at)
        levels = rt.engine.levels
        levels.set_should_record_ports(True)
        levels.record_ports = [("lane:2", 0)]
        levels.set_record_ports_filename_prefix(str(tmp_path / f"p{drain}"))
        levels.start_recording()
        rt.step_blocks(blocks - record_at)
        levels.stop_recording()
    return sink.stream(), len(sink.blocks)


def test_bounce_drain_32_bit_equal_to_per_block(tmp_path):
    """K=32: one device->host copy per 32 blocks; the delivered stream is
    bit-equal to per-block delivery, including the partial drain at the end
    of step_blocks and the switch to per-block delivery when a port
    recording starts mid-window."""
    plain, n1 = _drain_run(1)
    drained, n2 = _drain_run(32)
    assert n1 == n2 == 100
    np.testing.assert_array_equal(drained, plain)
    assert np.abs(plain).max() > 0.05
    mid, n3 = _drain_run(32, record_at=45, tmp_path=tmp_path)
    assert n3 == 100
    np.testing.assert_array_equal(mid, plain)


def test_bounce_drain_with_global_recording(tmp_path):
    """Global-playback recording rides the drain (fed from the batched
    master copy): the recorded WAV equals the per-block path's."""
    def run(drain, tag):
        rt = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=drain)
        rt.set_sink(NullSink())
        _start_ramp(rt, _ramp())
        lv = rt.engine.levels
        lv.set_record_global_playback(True)
        lv.set_global_playback_filename_prefix(str(tmp_path / f"{tag}.wav"))
        lv.start_recording()
        assert lv.only_global_recording()
        assert rt._draining() == (drain > 1)
        rt.step_blocks(40)
        lv.stop_recording()
        return read_wav(str(tmp_path / f"{tag}.wav")).samples

    plain = run(1, "plain")
    drained = run(5, "drained")
    assert plain.shape[0] == 40 * 128
    np.testing.assert_array_equal(drained, plain)


def test_pipelined_drain_delivers_one_window_late():
    """The pump's flush starts the batch's host copy and delivers the
    PREVIOUS batch; demanded flushes land everything, in order."""
    rt1 = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=1)
    sink1 = CaptureSink()
    rt1.set_sink(sink1)
    _start_ramp(rt1, _ramp())
    rt1.step_blocks(24)

    rt4 = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=4)
    sink4 = CaptureSink()
    rt4.set_sink(sink4)
    _start_ramp(rt4, _ramp())
    _pump_by_hand(rt4, 8)
    assert len(sink4.blocks) == 4, "the first window must stay in flight"
    assert rt4._pending_drain is not None
    _pump_by_hand(rt4, 10)
    rt4._flush_drain()
    assert rt4._pending_drain is None and len(sink4.blocks) == 18
    _pump_by_hand(rt4, 6)
    rt4._flush_drain()
    assert len(sink4.blocks) == 24
    np.testing.assert_array_equal(sink4.stream(), sink1.stream())


def test_demanded_flush_races_pipelined_flush():
    """Demanded flushes from an API thread serialize with the pump's
    pipelined flushes: hammered concurrently (with a short switch
    interval), the delivered stream is exactly the per-block stream."""
    import sys

    rt1 = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=1)
    sink1 = CaptureSink()
    rt1.set_sink(sink1)
    _start_ramp(rt1, _ramp())
    rt1.step_blocks(96)

    rt = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=3)
    sink = CaptureSink()
    rt.set_sink(sink)
    _start_ramp(rt, _ramp())
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            rt._flush_drain()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=hammer)
    t.start()
    try:
        _pump_by_hand(rt, 96)
    finally:
        stop.set()
        t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not t.is_alive()
    rt._flush_drain()
    assert len(sink.blocks) == 96
    np.testing.assert_array_equal(sink.stream(), sink1.stream())


def test_drain_flushes_before_per_block_resume(tmp_path):
    from libzl_tpu_torch.io.sinks import make_sink

    rt = EngineRuntime(device="cpu", num_voices=16, bounce_drain=8)
    out = tmp_path / "bounce.wav"
    rt.set_sink(make_sink(f"file:{out}", SR))
    try:
        _pump_by_hand(rt, 3)
        assert len(rt._drain_buf) == 3
        levels = rt.engine.levels
        levels.set_should_record_ports(True)
        levels.record_ports = [("master", 0)]
        levels.set_record_ports_filename_prefix(str(tmp_path / "ports"))
        levels.start_recording()
        _pump_by_hand(rt, 1)
        assert rt._drain_buf == [] and rt._pending_drain is None
        levels.stop_recording()
    finally:
        rt.set_sink(None)
    assert read_wav(out).num_frames == 4 * rt.engine.block_frames


# ---------------------------------------------------------- staging ring


class _KeepSink(AudioSink):
    """A pacing sink (the pump loop runs flat out, on the test's thread)
    that hands each block to `keep` as it was handed; after `stop_at`
    blocks it ends the pump loop; `at` maps a block count to an action run
    inside that block's write."""

    pacing = True

    def __init__(self, rt, keep, stop_at, at=None):
        self.rt, self.keep, self.stop_at, self.at = rt, keep, stop_at, at or {}
        self.n = 0

    def write(self, block):
        self.keep("sink", block)
        self.n += 1
        if self.n in self.at:
            self.at[self.n]()
        if self.n >= self.stop_at:
            self.rt._running = False


def _keeping(rt):
    """What the runtime hands its consumers, kept as handed beside a copy
    made when handed: the sink's blocks (through _KeepSink), every
    recorder's pushes, update_session's fetched arrays."""
    kept = {"sink": [], "recorders": [], "session": []}

    def keep(where, arr):
        kept[where].append((arr, np.array(arr)))

    levels = rt.engine.levels
    for rec in [levels._global_recorder, levels._ports_recorder,
                *levels._channel_recorders]:
        rec.push = lambda block, push=rec.push: (keep("recorders", block),
                                                 push(block))[1]
    update = rt.engine.update_session

    def update_session(res, include_recorders=True, fetched=None):
        for k in sorted(fetched):
            keep("session", fetched[k])
        return update(res, include_recorders=include_recorders,
                      fetched=fetched)

    rt.engine.update_session = update_session
    return kept, keep


def _record_ports(levels, prefix):
    """A take of three ports and channel 0 (per-block delivery of every
    output: the ring's payload of several parts)."""
    def start():
        levels.set_should_record_ports(True)
        levels.record_ports = [("lane:2", 0), ("master", 1),
                               ("strip:1:dry", 0)]
        levels.set_record_ports_filename_prefix(f"{prefix}p")
        levels.set_channels_to_record([0])
        levels.set_channel_filename_prefix(0, f"{prefix}c")
        levels.start_recording()
    return start


def _allocating(rt):
    """The runtime without its staging ring: every block's copy an
    allocating _HostCopy."""
    rt._ring.copy = lambda parts: None


def _assert_same_deliveries(got, want):
    for where in want:
        assert len(got[where]) == len(want[where]), where
        for (_, a), (_, b) in zip(got[where], want[where]):
            np.testing.assert_array_equal(a, b, err_msg=where)


def _assert_unchanged(kept):
    """Nothing handed on changed after it was handed: a slot reused under
    a sink or recorder that keeps its arrays would show here."""
    for where, pairs in kept.items():
        for i, (arr, copy) in enumerate(pairs):
            assert np.array_equal(arr, copy), f"{where} #{i} changed"


@pytest.mark.parametrize("record", [False, True], ids=["plain", "recording"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_stage_ring_delivers_as_the_allocating_copy(tmp_path, depth, record):
    """The pump loop at pipeline depth 0, 1 and 2 over 216 blocks (12
    meter-cadence blocks), a take of ports and a channel started and
    stopped mid-run: the sink, the recorders and update_session receive
    bit for bit what the allocating copy gives them; every block went
    through the ring, none fell back; and nothing a consumer kept changed
    after it was handed (the ring's slots are reused every depth + 2
    blocks)."""
    def run(ring):
        rt = EngineRuntime(SR, 128, 16, device="cpu", pipeline_depth=depth)
        if not ring:
            _allocating(rt)
        kept, keep = _keeping(rt)
        levels = rt.engine.levels
        at = ({60: _record_ports(levels, tmp_path / f"{ring}"),
               150: levels.stop_recording} if record else {})
        rt.set_sink(_KeepSink(rt, keep, 216, at))
        _start_ramp(rt, _ramp())
        rt._running = True
        rt._pump_blocks()
        rt.engine.drain_speculation()
        assert not levels.is_recording
        return rt, kept

    rt, got = run(True)
    _, want = run(False)
    blocks = rt.engine.total_blocks
    assert blocks == len(got["sink"]) == 216 + depth
    assert rt.phase_stats()["stage_ring_blocks"] == blocks
    assert rt.phase_stats()["stage_ring_fallbacks"] == 0
    assert len(got["session"]) == 4 * (blocks // rt.engine._levels_every)
    if record:
        assert len(got["recorders"]) == 90 * 2
    _assert_same_deliveries(got, want)
    assert np.abs(np.concatenate([a for a, _ in got["sink"]])).max() > 0.05
    _assert_unchanged(got)


def test_stage_ring_oversized_payload_falls_back(tmp_path):
    """A take started at a meter-cadence block behind 53 drained blocks:
    the drained blocks' peaks queue behind that block's fetch, so the next
    cadence block folds 34 queued peaks, more than a slot holds with every
    output; that one block takes the allocating copy, is counted in
    stage_ring_fallbacks, and every consumer receives what the allocating
    runtime gives it."""
    def run(ring):
        rt = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=64)
        if not ring:
            _allocating(rt)
        kept, keep = _keeping(rt)
        sink = CaptureSink()
        rt.set_sink(sink)
        _start_ramp(rt, _ramp())
        _pump_by_hand(rt, 53)
        assert len(rt._drain_buf) == 53
        assert (rt.engine.total_blocks + 1) % rt.engine._levels_every == 0
        _record_ports(rt.engine.levels, tmp_path / f"{ring}")()
        _pump_by_hand(rt, 40)
        rt.engine.levels.stop_recording()
        rt.engine.drain_speculation()
        kept["sink"] = [(b, b) for b in sink.blocks]
        return rt, kept

    rt, got = run(True)
    _, want = run(False)
    assert len(got["sink"]) == 93
    st = rt.phase_stats()
    assert (st["stage_ring_blocks"], st["stage_ring_fallbacks"]) == (39, 1)
    _assert_same_deliveries(got, want)
    _assert_unchanged(got)


@pytest.mark.cuda
def test_stage_ring_on_card_matches_host_copy():
    """On the card, the runtime of the live-loops benchmark cell (96
    voices, B=128, the horizon at H=16, pipeline depth 1) over 320 blocks
    of step_blocks(1): each block's ring copy (its master; the session
    arrays on meter-cadence blocks) is bit-equal to an allocating
    _HostCopy of the same tensors, and no block fell back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring's pinned slots and events")
    import sys

    from zlbench import harness, spec

    switch = sys.getswitchinterval()
    try:
        s = harness.build(spec.load_cell("live-loops"), 3300000001, "cuda:0")
    finally:
        sys.setswitchinterval(switch)
    rt = s.rt
    assert (rt.engine.block_frames, rt.engine._lookahead) == (128, 16)
    ring_copy = rt._ring.copy
    compared = []

    class Both:
        def __init__(self, mine, theirs):
            self.mine, self.theirs = mine, theirs

        def wait(self):
            got, want = self.mine.wait(), self.theirs.wait()
            compared.append((got.size, np.array_equal(got, want)))
            return got

    def both(parts):
        mine = ring_copy(parts)
        assert mine is not None, "a block fell back"
        return Both(mine, bridge._HostCopy(parts, rt.engine.device))

    rt._ring.copy = both
    before = rt.phase_stats()
    try:
        for _ in range(320):
            rt.step_blocks(1)
    finally:
        rt.engine.drain_speculation()
    after = rt.phase_stats()
    assert len(compared) == 320
    assert all(same for _, same in compared)
    assert sum(n > 256 for n, _ in compared) >= 320 // 18
    assert after["stage_ring_blocks"] - before["stage_ring_blocks"] == 320
    assert after["stage_ring_fallbacks"] == 0
    assert np.abs(s.sink.last[1]).max() > 0


# ---------------------------------------------------------- host copies


def _assert_host(x, where):
    """numpy float32 all the way down (tuples, dicts, RenderOutputs)."""
    if x is None:
        return
    if isinstance(x, dict):
        for v in x.values():
            _assert_host(v, where)
        return
    if isinstance(x, (tuple, list)):
        for v in x:
            _assert_host(v, where)
        return
    assert not torch.is_tensor(x), f"{where} received a tensor"
    assert isinstance(x, np.ndarray) and x.dtype == np.float32, \
        f"{where} received {type(x).__name__} {getattr(x, 'dtype', '')}"


@pytest.mark.parametrize("drain", [1, 32])
def test_host_consumers_receive_numpy_float32(tmp_path, drain):
    """The sink, the recorders (global, port, channel), the capture and
    block meters and the session update receive numpy float32 only, in
    per-block delivery and through the drain."""
    rt = EngineRuntime(SR, 128, 16, device="cpu", bounce_drain=drain)
    seen = {}

    def spy(obj, name, check):
        orig = getattr(obj, name)

        def wrapper(*args, **kwargs):
            seen[name] = seen.get(name, 0) + 1
            check(args, kwargs)
            return orig(*args, **kwargs)

        setattr(obj, name, wrapper)

    def every_arg(name):
        return lambda args, kwargs: _assert_host((args, kwargs), name)

    def fetched_given(args, kwargs):
        # the block's tensors stay on the device; the session arrays come
        # from the bridge's host copy
        assert kwargs.get("fetched") is not None
        _assert_host(kwargs["fetched"], "update_session")

    levels = rt.engine.levels
    for name in ("feed_recorders", "feed_global_recorder", "ingest_block",
                 "ingest_capture"):
        spy(levels, name, every_arg(name))
    spy(rt.engine, "update_session", fetched_given)

    class SpySink(AudioSink):
        def write(self, block):
            seen["sink"] = seen.get("sink", 0) + 1
            _assert_host(block, "sink")

    class Source:
        def read(self, frames):
            return np.full((frames, 2), 0.1, np.float32)

        def close(self):
            pass

    rt.set_sink(SpySink())
    _start_ramp(rt, _ramp())
    levels.set_record_global_playback(True)
    levels.set_global_playback_filename_prefix(str(tmp_path / "g.wav"))
    levels.start_recording()
    rt.step_blocks(40)               # global recording only: drain if K > 1
    levels.stop_recording()
    levels.set_should_record_ports(True)
    levels.record_ports = [("lane:2", 0), ("strip:1:dry", 1)]
    levels.set_record_ports_filename_prefix(str(tmp_path / "p.wav"))
    levels.set_channels_to_record([0])
    levels.set_channel_filename_prefix(0, str(tmp_path / "c"))
    rt.set_source(Source())
    levels.start_recording()
    rt.step_blocks(40)               # every recorder + capture: per block
    levels.stop_recording()
    for name in ("sink", "feed_recorders", "ingest_block", "ingest_capture",
                 "update_session"):
        assert seen.get(name, 0) > 0, f"{name} never called"
    assert seen["sink"] == 80
    assert (seen.get("feed_global_recorder", 0) > 0) == (drain > 1)
    port = read_wav(tmp_path / "p.wav").samples
    assert port.shape == (40 * 128, 2) and np.abs(port[:, 0]).max() > 0.05


# ------------------------------------------------- against the reference


def _bridge_session(mod, tmp_path, blocks, **init):
    """Three clips through `mod`'s C entry points: two looped, one one-shot,
    on three channels; a stop and a strip change mid-run. Returns the
    in-memory sink's stream."""
    mod.init_engine(**init)
    try:
        rt = mod._rt()
        sink = CaptureSink()
        rt.set_sink(sink)
        ids = [_make_clip(mod, tmp_path, seconds=s, name=f"c{i}.wav", freq=f)
               for i, (s, f) in enumerate([(0.3, 220.0), (0.05, 330.0),
                                           (0.2, 440.0)])]
        mod.clip_set_pan(ids[2], 0.4)
        mod.timer_start(120)
        mod.clip_play(ids[0], True, 0)
        mod.clip_play(ids[1], True, 1)
        mod.clip_play(ids[2], False, 2)
        rt.step_blocks(blocks // 2)
        mod.clip_stop(ids[0], 0)
        mod.passthrough_set(1, "pan", -0.3)
        rt.step_blocks(blocks - blocks // 2)
        return sink.stream()
    finally:
        mod.shutdown_engine()


def test_bridge_matches_reference_bridge(tmp_path, monkeypatch):
    """The same ABI session through the reference bridge (numpy backend)
    and the port's bridge on "cpu" (default engine: lookahead horizon and
    speculative chain): the sink streams agree within the bus tolerance
    (one voice per lane)."""
    from libzl_tpu.capi import bridge as ref_bridge
    from libzl_tpu.engine import hostcore as ref_hostcore

    # the reference engine takes its numpy program builder (held bit-equal
    # to the native core by tests/test_hostcore.py): no port test builds
    # the reference's native/ libraries
    monkeypatch.setattr(ref_hostcore, "available", lambda: False)
    monkeypatch.setenv("LIBZL_TPU_NO_PUMP", "1")
    monkeypatch.setenv("LIBZL_TPU_VOICES", "16")
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "numpy")
    want = _bridge_session(ref_bridge, tmp_path, 160)
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "cpu")
    got = _bridge_session(bridge, tmp_path, 160)
    assert got.shape == want.shape == (160 * 128, 2)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=MIX_RTOL,
                               atol=MIX_ATOL_PER_VOICE)
