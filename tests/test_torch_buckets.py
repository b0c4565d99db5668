"""Bucketed prefix rendering and the ratio ladder on the port (AudioEngine
on "cpu"), the scenarios of tests/test_voice_buckets.py and
tests/test_engine.py::test_ratio_ladder_dispatch.

First-idle allocation keeps live voices at low indices, so the engine
renders the smallest ladder bucket covering the highest active index;
bucketed and full renders are bit-equal per block, voice_peaks keeps the
pool's shape. A horizon engine with buckets is held to the full-pool horizon
at the reference's atol 1e-5 (tests/test_voice_buckets.py:228-244). The
ratio ladder renders the windows fetch at the lowest rung covering every
active pitch ratio: the same taps, so the same output as the top rung.
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
    """warmup renders the reference's work list: (bucket, rung, kind) for
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


# ------------------------------------------------------------ ratio ladder


def _ladder_engine(note, **kw):
    kw.setdefault("lookahead", 0)
    e = AudioEngine("cpu", sample_rate=SR, num_voices=16, fetch="windows",
                    **kw)
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


@pytest.mark.parametrize("note,rung", [(67, 2.0), (79, 4.0), (86, None)])
def test_ratio_ladder_rung_choice(note, rung):
    """Note 67 (ratio 1.5 over root 60) fits the 2.0 rung, note 79 (~3.0)
    needs the top rung, note 86 (~4.5) is over the envelope: gather."""
    e = _ladder_engine(note)
    assert e._ratio_ladder == [2.0, 4.0]
    e.process_block()
    pi, pf = _program(e)
    assert e._render_rmax(pi, pf) == rung
    # rungs are pruned below RUNG_MIN_SHARD_VOICES
    assert e._allowed_rungs(None) == [4.0]
    e.RUNG_MIN_SHARD_VOICES = 16
    assert e._allowed_rungs(None) == [2.0, 4.0]
    assert e._render_rmax(pi, pf, [4.0]) == (None if rung is None else 4.0)


@pytest.mark.parametrize("lookahead", [0, 8])
def test_ratio_ladder_dispatch_is_output_neutral(monkeypatch, lookahead):
    """The 2.0 rung renders through region_rows(B, 2.0) — bit-equal to the
    ladder-off engine; horizons take the rung, a lookahead engine's
    per-block dispatches the top rung only."""
    from libzl_tpu_torch.ops import voice as voice_ops

    # speculative chains of earlier tests' engines may still be rendering
    # on the process-wide workers: let them finish before spying
    AudioEngine._spec_sim_executor().submit(lambda: None).result()
    AudioEngine._spec_executor().submit(lambda: None).result()
    rmaxes = []
    orig = voice_ops.render_voices

    def spy(*a, **k):
        rmaxes.append(k["max_pitch_ratio"])
        return orig(*a, **k)

    outs = {}
    for ladder in ("auto", "off"):
        e = _ladder_engine(67, lookahead=lookahead, ratio_ladder=ladder)
        e.RUNG_MIN_SHARD_VOICES = 16
        monkeypatch.setattr(voice_ops, "render_voices", spy)
        rmaxes.clear()
        outs[ladder] = np.concatenate(
            [e.process_block().outputs.master.numpy() for _ in range(12)])
        monkeypatch.setattr(voice_ops, "render_voices", orig)
        e.drain_speculation()
        if ladder == "auto":
            seen = set(rmaxes)
        assert e.fetch_dispatches["gather"] == 0
    np.testing.assert_array_equal(outs["auto"], outs["off"])
    assert np.abs(outs["auto"]).max() > 0.05
    # per-block dispatches of a lookahead engine stay on the top rung
    assert seen == ({2.0} if lookahead == 0 else {2.0, 4.0})
