"""Bucketed prefix rendering and the pitch envelope on the port
(AudioEngine on "cpu"), the scenarios of tests/test_voice_buckets.py and
of tests/test_engine.py's ladder dispatch at the port's one rung.

First-idle allocation keeps live voices at low indices, so the engine
renders the smallest ladder bucket covering the highest active index;
bucketed and full renders are bit-equal per block, voice_peaks keeps the
pool's shape. A horizon engine with buckets is held to the full-pool horizon
at the reference's atol 1e-5 (tests/test_voice_buckets.py:228-244). The
windows fetch covers every pitch ratio up to `max_pitch_ratio`; a block
with a ratio past it renders through the gather fetch at the full pool.
"""

import numpy as np
import pytest

from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.ops.voice import pack_program
from libzl_tpu_torch.parallel import sharding

SR = 48000
FIELDS = ("master", "lane_mix", "strip_dry", "strip_wet1", "strip_wet2",
          "lane_peaks", "lane_rms", "master_peak", "voice_peaks")


def _make_engine(**kw):
    # lookahead off: bucketed vs full bit-equality is the per-block contract
    kw.setdefault("lookahead", 0)
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=128,
                      num_voices=128, **kw)
    t = np.arange(SR // 4) / SR
    wave = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[:, None]
    clip = ClipAudioSource(eng, audio=AudioData(wave, SR))
    eng.start_transport(bpm=120)
    return eng, clip


def _cmd(eng, clip, note, channel=0, stop=False, loop=True):
    cmd = ClipCommand.channel(clip.id, channel)
    cmd.midi_note = note
    if stop:
        cmd.stop_playback = True
    else:
        cmd.change_volume = True
        cmd.volume = 0.7
        cmd.start_playback = True
        cmd.looping = loop
    eng.schedule_clip_command(cmd, 0)


def _assert_outputs_equal(ra, rb, tag):
    for field in FIELDS:
        va = getattr(ra.outputs, field).numpy()
        vb = getattr(rb.outputs, field).numpy()
        assert va.shape == vb.shape, (field, tag)
        np.testing.assert_array_equal(va, vb, err_msg=f"{field} {tag}")


def test_ladder_shape():
    eng, _ = _make_engine()
    assert eng._bucket_ladder == [64, 128]
    assert _make_engine(voice_buckets="off")[0]._bucket_ladder is None
    assert AudioEngine("cpu", num_voices=64)._bucket_ladder is None
    assert AudioEngine("cpu", num_voices=1024)._bucket_ladder == \
        [64, 128, 256, 512, 1024]
    assert AudioEngine("cpu", num_voices=96)._bucket_ladder == [64, 96]
    with pytest.raises(ValueError):
        AudioEngine("cpu", num_voices=128, voice_buckets="banana")


@pytest.mark.parametrize("kw,graphs", [
    ({}, 2),                                       # block per bucket
    ({"lookahead": 8}, 4),                         # + horizon per bucket
    ({"fetch": "windows"}, 3),                     # + full-pool gather
    ({"lookahead": 8, "fetch": "windows"}, 6),
])
def test_warmup_renders_every_dispatch(kw, graphs):
    """warmup renders the reference's work list: (bucket, kind) for
    every dispatch the session can make, and nothing else."""
    eng, clip = _make_engine(**kw)
    assert eng.warmup() == graphs
    assert eng.stats()["warmed_graphs"] == graphs
    _cmd(eng, clip, 60)
    res = eng.process_block()
    assert res.outputs.master.shape == (128, 2)


def test_bucketed_matches_full_render():
    eng_a, clip_a = _make_engine()
    eng_b, clip_b = _make_engine(voice_buckets="off")
    for i in range(6):
        _cmd(eng_a, clip_a, 60 + i, channel=i % 4)
        _cmd(eng_b, clip_b, 60 + i, channel=i % 4)
    for b in range(8):
        ra, rb = eng_a.process_block(), eng_b.process_block()
        assert eng_a._render_bucket() == 64
        _assert_outputs_equal(ra, rb, f"block {b}")
    assert np.abs(ra.outputs.master.numpy()).max() > 0.05


def test_prefix_dispatch_uploads_the_bucket_only(monkeypatch):
    """A bucketed dispatch renders the prefix of the pool and pads
    voice_peaks back to the pool size."""
    eng, clip = _make_engine()
    rows = []
    orig = sharding.render_block_sharded

    def spy(mesh, sound, fused, strips, **kw):
        rows.append((fused.shape[0], kw["pad_voices_to"]))
        return orig(mesh, sound, fused, strips, **kw)

    monkeypatch.setattr(sharding, "render_block_sharded", spy)
    _cmd(eng, clip, 60)
    res = eng.process_block()
    assert rows == [(64, 128)]
    assert res.outputs.voice_peaks.shape == (128,)


def test_dying_high_voice_renders_final_block():
    """The bucket comes from the packed program's active column, not
    pool.active: under the native host core the pool is already past this
    block's deaths at dispatch, and a dying high voice still renders its
    final frames."""
    eng_a, clip_a = _make_engine()
    eng_b, clip_b = _make_engine(voice_buckets="off")
    assert eng_a.use_native_host
    pairs = ((eng_a, clip_a), (eng_b, clip_b))
    for eng, clip in pairs:
        for i in range(70):
            _cmd(eng, clip, 30 + i % 60, channel=i % 10)
    for b in range(2):
        _assert_outputs_equal(eng_a.process_block(), eng_b.process_block(),
                              f"warm {b}")
    for eng, clip in pairs:
        for i in range(69):
            _cmd(eng, clip, 30 + i % 60, channel=i % 10, stop=True)
    _assert_outputs_equal(eng_a.process_block(), eng_b.process_block(),
                          "stop")
    for eng, clip in pairs:
        _cmd(eng, clip, 30 + 69 % 60, channel=69 % 10, stop=True)
    for b in range(30):
        _assert_outputs_equal(eng_a.process_block(), eng_b.process_block(),
                              f"death-sequence block {b}")


def test_bucket_churn_equivalence_fuzz():
    """Random traffic crossing bucket boundaries both ways: bucketed and
    full renders bit-equal block for block."""
    rng = np.random.default_rng(11)
    eng_a, clip_a = _make_engine()
    eng_b, clip_b = _make_engine(voice_buckets="off")
    notes_on = set()
    buckets = set()
    for b in range(120):
        roll = rng.random()
        if roll < 0.45:
            note = int(rng.integers(24, 96))
            ch = int(rng.integers(0, 10))
            looping = bool(rng.integers(0, 2))
            for eng, clip in ((eng_a, clip_a), (eng_b, clip_b)):
                _cmd(eng, clip, note, ch, loop=looping)
            notes_on.add((note, ch))
        elif roll < 0.75 and notes_on:
            note, ch = sorted(notes_on)[int(rng.integers(0, len(notes_on)))]
            notes_on.discard((note, ch))
            for eng, clip in ((eng_a, clip_a), (eng_b, clip_b)):
                _cmd(eng, clip, note, ch, stop=True)
        if b % 7 == 0:   # bursts push the high water past the first bucket
            for i in range(12):
                note, ch = 30 + (b + i) % 60, i % 10
                for eng, clip in ((eng_a, clip_a), (eng_b, clip_b)):
                    _cmd(eng, clip, note, ch, loop=False)
        ra, rb = eng_a.process_block(), eng_b.process_block()
        _assert_outputs_equal(ra, rb, f"block {b}")
        assert np.array_equal(eng_a.pool.active, eng_b.pool.active)
        buckets.add(eng_a._render_bucket())
    assert buckets == {64, 128}


def test_bucket_tracks_high_water():
    eng, clip = _make_engine()
    for i in range(4):
        _cmd(eng, clip, 60 + i)
    eng.process_block()
    assert eng._render_bucket() == 64
    for i in range(70):
        _cmd(eng, clip, 30 + (i % 60), channel=1 + i % 9)
    res = eng.process_block()
    assert int(eng.pool.active.sum()) > 64
    assert eng._render_bucket() == 128
    assert res.outputs.voice_peaks.shape == (128,)
    for i in range(4):
        _cmd(eng, clip, 60 + i, stop=True)
    for i in range(70):
        _cmd(eng, clip, 30 + (i % 60), channel=1 + i % 9, stop=True)
    for _ in range(40):
        eng.process_block()
        if not eng.pool.active.any():
            break
    assert not eng.pool.active.any()
    _cmd(eng, clip, 72)
    eng.process_block()
    assert eng._render_bucket() == 64


def test_lookahead_bucket_tolerance():
    """Bucketed horizons against full-pool horizons through build, adoption
    and emission, at the reference's atol 1e-5."""
    eng_a, clip_a = _make_engine(lookahead=8)
    eng_b, clip_b = _make_engine(lookahead=8, voice_buckets="off")
    for eng, clip in ((eng_a, clip_a), (eng_b, clip_b)):
        for i in range(12):
            _cmd(eng, clip, 40 + i, channel=i % 10)
    for b in range(24):
        ra, rb = eng_a.process_block(), eng_b.process_block()
        np.testing.assert_allclose(ra.outputs.master.numpy(),
                                   rb.outputs.master.numpy(), atol=1e-5,
                                   err_msg=f"block {b}")
    assert eng_a._h_slices and eng_b._h_slices
    assert eng_a.stats()["slo_by_kind"]["adopt"][1] >= 1


@pytest.mark.parametrize("lookahead", [0, 8])
def test_bucketed_sparse_session_is_bit_equal(lookahead):
    """A sparse session (12 voices of a 128-voice pool, the 64-voice
    bucket) against voice_buckets="off", per-block and through horizon
    builds, adoptions and emission: every output bit-equal. The reference
    allows atol 1e-5 (tests/test_voice_buckets.py:228-244); the port's
    in-order lane mixdown adds only +0.0 for the idle tail, which changes
    no bit."""
    eng_a, clip_a = _make_engine(lookahead=lookahead)
    eng_b, clip_b = _make_engine(lookahead=lookahead, voice_buckets="off")
    for eng, clip in ((eng_a, clip_a), (eng_b, clip_b)):
        for i in range(12):
            _cmd(eng, clip, 40 + i, channel=i % 10)
    for b in range(24):
        ra, rb = eng_a.process_block(), eng_b.process_block()
        _assert_outputs_equal(ra, rb, f"block {b}")
        assert eng_a._render_bucket() == 64
    assert np.abs(ra.outputs.master.numpy()).max() > 0.05
    if lookahead:
        assert eng_a.stats()["slo_by_kind"]["adopt"][1] >= 1
    eng_a.drain_speculation()
    eng_b.drain_speculation()


# --------------------------------------------------------- pitch envelope


def _envelope_engine(note, **kw):
    kw.setdefault("lookahead", 0)
    kw.setdefault("fetch", "windows")
    e = AudioEngine("cpu", sample_rate=SR, num_voices=16, **kw)
    t = np.arange(12000) / SR
    c = ClipAudioSource(e, audio=AudioData(
        (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)[:, None], SR))
    e.start_transport(bpm=120)
    _cmd(e, c, note, channel=1)
    return e


def _program(e):
    prog = e.pool.build_program(
        block_start_sample=float(e.clock.sample_position),
        tick_anchor_sample=e.clock.anchor_sample,
        tick_anchor=e.clock.anchor_tick,
        samples_per_tick=e.clock.samples_per_tick,
        lane_enabled=e.lane_enabled)
    return pack_program(prog)


@pytest.mark.parametrize("note,fits", [(67, True), (79, True), (86, False)])
def test_pitch_envelope_choice(note, fits):
    """Note 67 (ratio 1.5 over root 60) and note 79 (~3.0) fit the windows
    envelope (max_pitch_ratio 4.0), note 86 (~4.5) is over it: the block
    renders through the full-pool gather (lib/SamplerSynthVoice.cpp:115-116
    bounds no ratio)."""
    e = _envelope_engine(note)
    e.process_block()
    pi, pf = _program(e)
    assert e._fits_envelope(pi, pf) is fits
    e.process_block()
    assert e.fetch_dispatches == ({"windows": 2, "gather": 0} if fits
                                  else {"windows": 0, "gather": 2})


@pytest.mark.parametrize("envelope,note,fits", [
    (2.0, 67, True), (2.0, 79, False), (3.0, 79, True), (3.0, 86, False)])
def test_envelope_is_max_pitch_ratio(envelope, note, fits):
    """The windows envelope is the engine's `max_pitch_ratio`, whatever it
    is set to: note 67 (ratio 1.5) fits 2.0, note 79 (~2.997) fits 3.0 and
    not 2.0, note 86 (~4.5) fits neither."""
    e = _envelope_engine(note, max_pitch_ratio=envelope)
    e.process_block()
    pi, pf = _program(e)
    assert e._fits_envelope(pi, pf) is fits
    assert e.fetch_dispatches == {"windows": int(fits),
                                  "gather": int(not fits)}


@pytest.mark.parametrize("lookahead", [0, 8])
def test_over_envelope_dispatch_matches_gather(lookahead):
    """An over-envelope note in a windows engine renders through the gather
    fetch, per block and in horizons alike, within the windows-vs-gather
    tolerance of a gather engine's blocks."""
    outs = {}
    for fetch in ("windows", "gather"):
        e = _envelope_engine(86, lookahead=lookahead, fetch=fetch)
        outs[fetch] = np.concatenate(
            [e.process_block().outputs.master.numpy() for _ in range(12)])
        e.drain_speculation()
        if fetch == "windows":
            # horizons count their slices, speculative ones included
            assert e.fetch_dispatches["windows"] == 0
            assert e.fetch_dispatches["gather"] >= 12
            assert (e.render_dispatches["horizon"] > 0) == bool(lookahead)
    np.testing.assert_allclose(outs["windows"], outs["gather"], atol=2e-6)
    assert np.abs(outs["windows"]).max() > 0.05
