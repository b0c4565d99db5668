"""The port's lookahead horizon and speculative chain (AudioEngine on "cpu").

The scenarios of tests/test_lookahead.py on the port: each horizon engine is
held BIT-equal to the same port engine at lookahead=0 — the horizon is H
per-block programs simulated by the host, rendered by the same per-block
math, so the contract is exact equality. One differential runs the port's
default engine (lookahead=8, voice buckets "auto") against the reference
`AudioEngine(backend="jax", lookahead=8, fetch="gather")` under random
traffic at the engine tolerance (voice peaks rtol 2e-6 / atol 1e-9; master
rtol 1e-5 / atol 2e-6 per voice in the densest lane). Two faults of the
reference are repaired in the port and tested here: the speculation depth
parse and the `slo_worst` ranking.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from libzl_tpu.engine import commands as ref_commands
from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.io import wav as ref_wav
from libzl_tpu.models import clip as ref_clip
from libzl_tpu_torch.engine import engine as engine_mod
from libzl_tpu_torch.engine import hostcore as hostcore_mod
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.ops import fetch_windows as fw
from libzl_tpu_torch.ops import voice as host_voice

SR = 48000


def _tone(seconds=0.5, freq=220.0, audio_data=AudioData):
    t = np.arange(int(SR * seconds)) / SR
    return audio_data(
        (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None], SR
    )


def _engine(lookahead, voices=64, block=128, **kw):
    eng = AudioEngine("cpu", block_frames=block, num_voices=voices,
                      lookahead=lookahead, **kw)
    clip = ClipAudioSource(eng, audio=_tone())
    eng.start_transport(bpm=120)
    return eng, clip


def _run_script(lookahead, script, blocks=100, **kw):
    """Run `blocks` with script = {block_index: fn(eng, clip)}."""
    eng, clip = _engine(lookahead, **kw)
    outs, peaks = [], []
    for i in range(blocks):
        if i in script:
            script[i](eng, clip)
        res = eng.process_block()
        outs.append(res.outputs.master.numpy().copy())
        peaks.append(res.outputs.voice_peaks.numpy().copy())
    return np.concatenate(outs), np.stack(peaks), eng


def _play(eng, clip, note=60, channel=0, loop=True):
    cmd = ClipCommand.channel(clip.id, channel)
    cmd.midi_note = note
    # a start without change_volume is silent (volume 0.0, as in the
    # reference): these scenarios compare audible output
    cmd.change_volume = True
    cmd.volume = 0.8
    cmd.start_playback = True
    cmd.looping = loop
    cmd.change_looping = loop
    eng.schedule_clip_command(cmd, 0)


def _spy(eng, name, calls):
    orig = getattr(type(eng), name)

    def spy(self, *a, **k):
        calls.append(self.total_blocks)
        return orig(self, *a, **k)

    setattr(eng, name, spy.__get__(eng))


@pytest.mark.parametrize("host_core", ["auto", "numpy"])
def test_clean_session_matches_per_block(host_core):
    script = {0: lambda e, c: _play(e, c)}
    on, pk_on, eng = _run_script("auto", script, host_core=host_core)
    off, pk_off, _ = _run_script(0, script, host_core=host_core)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)
    assert np.abs(on).max() > 0.1 and pk_on.max() > 0.1
    assert eng._lookahead == 16
    assert eng._h_slices, "horizon never engaged"
    assert eng.use_native_host == (host_core == "auto")


def test_midhorizon_event_preempts_with_exact_timing():
    """A note landing mid-horizon sounds at exactly the same frame as
    per-block dispatch: the horizon preempts, it does not delay."""
    script = {
        0: lambda e, c: _play(e, c),
        17: lambda e, c: _play(e, c, note=67, channel=1),
        18: lambda e, c: _play(e, c, note=72, channel=2),
        45: lambda e, c: _play(e, c, note=48, channel=3),
    }
    on, pk_on, _ = _run_script("auto", script)
    off, pk_off, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)


def test_event_block_rebuilds_horizon():
    """An event after a long clean run rebuilds the horizon in the SAME
    block (H-block budget, kind event_rebuild); back-to-back events do
    not."""
    eng, clip = _engine("auto")
    starts = []
    _spy(eng, "_start_horizon", starts)
    _play(eng, clip)
    for _ in range(30):
        eng.process_block()
    assert starts and starts[0] == 3
    _play(eng, clip, note=67, channel=1)
    event_block = None
    for _ in range(3):
        n = eng.total_blocks
        eng.process_block()
        if eng._blocks_since_event == 0:
            event_block = n
            break
    assert event_block is not None, "scheduled event never fired"
    assert starts[-1] == event_block, "event block did not rebuild"
    assert eng._h_built_this_block
    assert eng.stats()["slo_by_kind"]["event_rebuild"][1] == 1
    _play(eng, clip, note=72, channel=2)
    for _ in range(3):
        n = eng.total_blocks
        eng.process_block()
        if eng._blocks_since_event == 0:
            assert n not in starts, "storm-gap event must not rebuild"
            break


def test_out_of_band_mutations_preempt():
    """Direct set_bpm / set_strip / lane toggles bypass the command hooks;
    the fingerprint still preempts stale slices."""
    def mutate_bpm(e, c):
        e.set_bpm(151.5)

    def mutate_strip(e, c):
        e.set_strip(0, dry=0.6, pan=-0.4)

    def mutate_lane(e, c):
        e.lane_enabled[5] = False

    script = {0: lambda e, c: _play(e, c),
              20: mutate_bpm, 40: mutate_strip, 60: mutate_lane}
    on, _, _ = _run_script("auto", script)
    off, _, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)


def test_stop_transport_and_noteoff_midhorizon():
    def stop_note(e, c):
        cmd = ClipCommand.channel(c.id, 0)
        cmd.midi_note = 60
        cmd.stop_playback = True
        e.schedule_clip_command(cmd, 0)

    script = {0: lambda e, c: _play(e, c), 30: stop_note,
              50: lambda e, c: e.stop_transport()}
    on, _, _ = _run_script("auto", script)
    off, _, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)


def test_oneshot_death_midhorizon_releases_positions():
    script = {0: lambda e, c: _play(e, c, loop=False)}
    on, _, eng_on = _run_script("auto", script, blocks=220)
    off, _, eng_off = _run_script(0, script, blocks=220)
    np.testing.assert_array_equal(on, off)
    assert int(eng_on.pool.active.sum()) == 0
    assert int(eng_off.pool.active.sum()) == 0


def test_event_storm_degrades_to_per_block():
    eng, clip = _engine("auto")
    starts = []
    _spy(eng, "_start_horizon", starts)
    for i in range(30):
        _play(eng, clip, note=40 + i % 20, channel=i % 10)
        eng.process_block()
    assert not starts
    assert "per_block" in eng.stats()["slo_by_kind"]


def test_spec_pipeline_adopts_next_horizon():
    """Quiet runs pipeline horizons: _start_horizon once, every later
    horizon adopted from the chain at exhaustion, the spec block's budget
    the H-2 slices in hand, adoptions accounted under their own kind."""
    eng, clip = _engine("auto")
    starts, adopts, specs = [], [], []
    _spy(eng, "_start_horizon", starts)
    _spy(eng, "_adopt_spec", adopts)
    _spy(eng, "_maybe_build_spec", specs)
    _play(eng, clip)
    budgets = []
    for _ in range(60):
        eng.process_block()
        if eng._spec_built_this_block:
            budgets.append(len(eng._h_slices) - eng._h_cursor)
    H = eng._lookahead
    assert starts == [3]
    assert specs and specs[0] == 4
    assert adopts, "speculative horizon never adopted"
    assert adopts == [3 + H * (k + 1) for k in range(len(adopts))]
    assert budgets and all(b == H - 2 for b in budgets)
    by_kind = eng.slo.by_kind
    assert "adopt" in by_kind and by_kind["adopt"][1] == len(adopts)
    assert by_kind["emit"][1] == eng.slo.total_blocks - len(starts) \
        - len(adopts) - len(specs) - by_kind.get("idle", [0, 0])[1] \
        - by_kind.get("per_block", [0, 0])[1]
    assert eng.stats()["spec_failures"] == 0
    assert "adopt_wait" in eng.profiler.summary()


def test_event_discards_spec_horizon():
    script = {0: lambda e, c: _play(e, c),
              25: lambda e, c: _play(e, c, note=71, channel=5)}
    on, pk_on, _ = _run_script("auto", script)
    off, pk_off, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)


def test_pool_mirror_tracks_emission_frontier():
    eng, clip = _engine("auto")
    eng_off, clip_off = _engine(0)
    _play(eng, clip)
    _play(eng_off, clip_off)
    for _ in range(20):
        res = eng.process_block()
        eng_off.process_block()
    assert eng._h_slices and eng._h_cursor < len(eng._h_slices), \
        "expected to be mid-horizon"
    np.testing.assert_array_equal(eng.pool.pos_int, eng_off.pool.pos_int)
    np.testing.assert_array_equal(eng.pool.pos_frac, eng_off.pool.pos_frac)
    np.testing.assert_array_equal(eng.pool.env, eng_off.pool.env)
    eng.update_session(res)  # must not disturb the mirror
    np.testing.assert_array_equal(eng.pool.pos_int, eng_off.pool.pos_int)


def test_lookahead_with_bq_short_loop():
    def play_bq(e, c):
        c.length_beats = 0.0
        _play(e, c)

    on, _, _ = _run_script("auto", {0: play_bq})
    off, _, _ = _run_script(0, {0: play_bq})
    np.testing.assert_array_equal(on, off)


def test_unencodable_dynamics_fall_back_to_per_block(monkeypatch):
    """A program the compact encoding cannot carry (native or numpy sim)
    leaves the horizon unbuilt; per-block dispatch takes the block with the
    pool state intact."""
    script = {0: lambda e, c: _play(e, c)}
    off, pk_off, _ = _run_script(0, script, blocks=40)
    monkeypatch.setattr(host_voice, "pack_horizon_dynamics",
                        lambda *a, **k: None)
    monkeypatch.setattr(hostcore_mod, "horizon_update", lambda *a, **k: None)
    for host_core in ("auto", "numpy"):
        on, pk_on, eng_on = _run_script("auto", script, blocks=40,
                                        host_core=host_core)
        assert not eng_on._h_slices, "horizon must not engage"
        np.testing.assert_array_equal(on, off)
        np.testing.assert_array_equal(pk_on, pk_off)


def test_discarded_spec_build_early_exits_on_worker():
    """An event that discards the speculation while its build is still
    QUEUED on the sim worker cancels the build (generation check)."""
    eng, clip = _engine("auto")
    _play(eng, clip)
    for _ in range(4):
        eng.process_block()  # horizon at block 3
    sims = []
    orig_sim = type(eng)._sim_horizon_bundle

    def spy(self, *a, **k):
        sims.append(1)
        return orig_sim(self, *a, **k)

    eng._sim_horizon_bundle = spy.__get__(eng)
    gate = threading.Event()
    blocker = eng._spec_sim_executor().submit(gate.wait, 5.0)
    eng.process_block()  # h_cursor == 2: chain launched behind the blocker
    assert eng._spec_built_this_block
    chain = eng._h_next
    assert chain is not None
    eng._mark_event()
    gate.set()
    assert blocker.result(timeout=10)
    eng._spec_sim_executor().submit(lambda: None).result(timeout=10)
    assert chain.dead and chain.entries.empty()
    assert not sims, "orphaned build must never run the horizon sim"


def test_spec_depth_fixed_near_events(monkeypatch):
    eng, clip = _engine("auto")
    _play(eng, clip)
    for _ in range(5):
        eng.process_block()
    chain = eng._h_next
    assert chain is not None
    assert eng._blocks_since_event < 4 * eng._lookahead
    assert chain._depth_now() == chain.depth == engine_mod.DEFAULT_SPEC_DEPTH
    monkeypatch.setenv("LIBZL_TPU_SPEC_DEPTH", "3")
    eng3, clip3 = _engine("auto")
    _play(eng3, clip3)
    for _ in range(5):
        eng3.process_block()
    assert eng3._h_next.depth == eng3._h_next._depth_now() == 3


@pytest.mark.parametrize("value", ["two", "0", "-1", "1.5"])
def test_bad_spec_depth_raises_at_construction(monkeypatch, value):
    """The reference parses LIBZL_TPU_SPEC_DEPTH with a bare int() at import
    (a bad value breaks the import with a message that names nothing); the
    port checks it at engine construction and names the variable."""
    monkeypatch.setenv("LIBZL_TPU_SPEC_DEPTH", value)
    with pytest.raises(ValueError, match="LIBZL_TPU_SPEC_DEPTH"):
        AudioEngine("cpu", num_voices=8)
    monkeypatch.setenv("LIBZL_TPU_SPEC_DEPTH", " ")
    assert AudioEngine("cpu", num_voices=8)._spec_depth == 2


def test_slo_worst_records_miss_context():
    eng, clip = _engine("auto")
    _play(eng, clip)
    eng.process_block()
    eng.slo.budget = 0.0  # every later block misses its deadline
    for _ in range(eng.SLO_WORST_KEEP + 8):
        eng.process_block()
    worst = eng.stats()["slo_worst"]
    assert 0 < len(worst) <= eng.SLO_WORST_KEEP
    assert all(r["overrun_ms"] >= worst[-1]["overrun_ms"] for r in worst)
    rec = worst[0]
    for key in ("kind", "ms", "overrun_ms", "budget_blocks", "block",
                "h_cursor", "blocks_since_event", "chain"):
        assert key in rec
    assert rec["kind"] in ("emit", "horizon", "event_rebuild", "adopt",
                           "spec", "per_block", "idle")


def test_slo_worst_ranks_by_overrun_not_busy_time():
    """A 16-block horizon build that took 45 ms overran its 42.7 ms budget
    by 2.3 ms; a 1-block emit that took 12 ms overran by 9.3 ms. The worse
    miss is the emit: the reference ranks by busy ms and would keep the
    horizon first (and drop the emit first when the ring is full)."""
    eng, _ = _engine("auto")
    period = eng.slo.budget
    eng._note_slo_miss("horizon", 45e-3, 16)
    eng._note_slo_miss("emit", 12e-3, 1)
    worst = eng.stats()["slo_worst"]
    assert [r["kind"] for r in worst] == ["emit", "horizon"]
    assert worst[0]["overrun_ms"] == round((12e-3 - period) * 1e3, 3)
    # a full ring drops the smallest overrun, however long its busy time
    for i in range(eng.SLO_WORST_KEEP - 1):
        eng._note_slo_miss("emit", period + (3 + i) * 1e-3, 1)
    kinds = [r["kind"] for r in eng.stats()["slo_worst"]]
    assert len(kinds) == eng.SLO_WORST_KEEP and "horizon" not in kinds


def test_spec_dispatch_failure_is_counted_and_falls_back(monkeypatch):
    """A speculative dispatch that raises on the worker falls back to a
    synchronous horizon (the reference's semantics, so the audio is still
    bit-equal to per-block) and is counted, with its traceback, in
    stats() — the reference drops it silently."""
    from libzl_tpu_torch.parallel import sharding

    orig = sharding.render_horizon_sharded

    def flaky(*a, **k):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("launch failed on the dispatch thread")
        return orig(*a, **k)

    monkeypatch.setattr(sharding, "render_horizon_sharded", flaky)
    script = {0: lambda e, c: _play(e, c)}
    on, pk_on, eng = _run_script("auto", script, blocks=40)
    monkeypatch.setattr(sharding, "render_horizon_sharded", orig)
    off, pk_off, _ = _run_script(0, script, blocks=40)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)
    stats = eng.stats()
    assert stats["spec_failures"] >= 1
    assert "launch failed on the dispatch thread" in stats["spec_last_failure"]
    assert "adopt" not in stats["slo_by_kind"]


def test_fetch_dispatches_count_every_rendered_slice():
    """fetch_dispatches counts per-block dispatches and horizon slices
    rendered, speculative ones included (the kernel launch count on the
    card must equal it)."""
    eng, clip = _engine("auto", fetch="windows")
    _play(eng, clip)
    starts = []
    _spy(eng, "_start_horizon", starts)
    for _ in range(40):
        eng.process_block()
    eng.drain_speculation()
    H = eng._lookahead
    by_kind = eng.stats()["slo_by_kind"]
    per_block = by_kind.get("per_block", [0, 0])[1]
    n = eng.fetch_dispatches["windows"]
    assert eng.fetch_dispatches["gather"] == 0
    assert (n - per_block) % H == 0
    # the sync horizon + one chained horizon per adoption + what the chain
    # had rendered ahead when drained (up to its depth)
    horizons = (n - per_block) // H
    assert len(starts) + by_kind["adopt"][1] <= horizons \
        <= len(starts) + by_kind["adopt"][1] + eng._spec_depth


def test_launch_count_is_safe_under_threads():
    """The kernel's launch count is bumped by the engine thread and the
    dispatch thread: no increment may be lost."""
    before = fw.fetch_interp.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fw._count_launch() for _ in range(5000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fw.fetch_interp.launches - before == 8 * 5000
    fw.fetch_interp.launches = before


@pytest.mark.parametrize("seed", [7, 2024])
def test_random_traffic_differential(seed):
    """The same seeded command stream through a horizon engine and a
    per-block engine: bit-equal audio, voice peaks and end state."""
    on, pk_on, eng_on, _ = _random_traffic(
        lambda: _build_random(AudioEngine, "cpu", lookahead="auto"), seed)
    off, pk_off, eng_off, _ = _random_traffic(
        lambda: _build_random(AudioEngine, "cpu", lookahead=0), seed)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)
    np.testing.assert_array_equal(eng_on.pool.active, eng_off.pool.active)
    np.testing.assert_array_equal(eng_on.pool.pos_int, eng_off.pool.pos_int)
    assert eng_on.stats()["spec_failures"] == 0
    assert np.abs(on).max() > 0.05


def _build_random(cls, *args, voices=32, **kw):
    """An engine with four clips, each engine with its own package's clip
    and audio types."""
    eng = cls(*args, block_frames=128, num_voices=voices, **kw)
    ref = cls is RefEngine
    clip_cls = ref_clip.ClipAudioSource if ref else ClipAudioSource
    data_cls = ref_wav.AudioData if ref else AudioData
    clips = [clip_cls(eng, audio=_tone(0.08 + 0.11 * i, 150.0 + 90 * i,
                                       data_cls))
             for i in range(4)]
    eng.start_transport(bpm=120)
    return eng, clips


def _random_traffic(build, seed, blocks=110):
    """Notes on/off at random delays, BPM jumps, transport toggles, strip
    mutations, lane freezes (tests/test_lookahead.py's fuzz). Returns
    (master [blocks, B, 2], voice_peaks [blocks, V], engine, voices in the
    densest lane per block)."""
    eng, clips = build()
    command = (ref_commands.ClipCommand if isinstance(eng, RefEngine)
               else ClipCommand)
    rng = np.random.default_rng(seed)
    outs, peaks, dens = [], [], []
    for _ in range(blocks):
        roll = rng.random()
        clip = clips[int(rng.integers(0, len(clips)))]
        ch = int(rng.integers(0, 10))
        if roll < 0.10:
            cmd = command.channel(clip.id, ch)
            cmd.midi_note = int(rng.integers(40, 80))
            cmd.start_playback = True
            # a start without change_volume is silent (volume 0.0, as in
            # the reference): give every note a level
            cmd.change_volume = True
            cmd.volume = float(rng.uniform(0.3, 1.0))
            cmd.looping = bool(rng.integers(0, 2))
            cmd.change_looping = cmd.looping
            eng.schedule_clip_command(cmd, int(rng.integers(0, 6)))
        elif roll < 0.14:
            cmd = command.channel(clip.id, ch)
            cmd.midi_note = int(rng.integers(40, 80))
            cmd.stop_playback = True
            eng.schedule_clip_command(cmd, int(rng.integers(0, 4)))
        elif roll < 0.16:
            eng.set_bpm(float(rng.uniform(60, 180)))
        elif roll < 0.18:
            eng.set_strip(int(rng.integers(-1, 10)),
                          dry=float(rng.uniform(0.2, 1)),
                          pan=float(rng.uniform(-1, 1)))
        elif roll < 0.19:
            eng.lane_enabled[int(rng.integers(0, 12))] = bool(
                rng.integers(0, 2))
        elif roll < 0.20 and eng.transport_running:
            eng.stop_transport()
        elif roll < 0.21 and not eng.transport_running:
            eng.start_transport()
        act = eng.pool.active.copy()
        res = eng.process_block()
        o = res.outputs
        outs.append(np.asarray(torch.as_tensor(o.master)).copy())
        peaks.append(np.asarray(torch.as_tensor(o.voice_peaks)).copy())
        act |= eng.pool.active
        dens.append(int(np.bincount(eng.pool.lane[act], minlength=12).max())
                    if act.any() else 0)
    return np.stack(outs), np.stack(peaks), eng, dens


def test_default_engine_matches_reference_jax_under_random_traffic():
    """The port's default engine (horizon H=8, voice buckets "auto" over
    128 voices) against the reference jax engine with the same options and
    the gather fetch, block by block, at the engine tolerance."""
    seed = 11
    got, pk_got, port, dens = _random_traffic(
        lambda: _build_random(AudioEngine, "cpu", voices=128, lookahead=8),
        seed)
    want, pk_want, ref, _ = _random_traffic(
        lambda: _build_random(RefEngine, voices=128, backend="jax",
                              lookahead=8, fetch="gather",
                              host_core="numpy"), seed)
    assert port._lookahead == ref._lookahead == 8
    assert port._bucket_ladder == ref._bucket_ladder == [64, 128]
    for b in range(len(got)):
        np.testing.assert_allclose(pk_got[b], pk_want[b], rtol=2e-6,
                                   atol=1e-9, err_msg=f"block {b} peaks")
        np.testing.assert_allclose(got[b], want[b], rtol=1e-5,
                                   atol=2e-6 * max(dens[b], 1),
                                   err_msg=f"block {b} master")
    kinds = port.stats()["slo_by_kind"]
    assert kinds.get("horizon", [0, 0])[1] + kinds.get(
        "event_rebuild", [0, 0])[1] >= 1
    assert np.abs(got).max() > 0.05
