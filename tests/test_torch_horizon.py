"""The port's compact lookahead horizon against the reference.

Programs come from the host sim the engine runs (VoicePool.build_program +
advance, block by block) over a session with a steady loop, a short
positional loop, a one-shot that auto-releases and dies mid-horizon, a
beat-quantized loop and a pending note-off on the build block — so the
dynamics carry the 16-bit release sentinel, the release rate fixed by the
build block's note-off, wrap frames, deaths and (at B=1024) the bq_reset
columns.

- unpack_horizon_slice / horizon_programs: bit-equal to the reference's
  numpy path on the same dynamics (pack_horizon_dynamics);
- render_horizon_onebuf / _compact / _fused: bit-equal to H calls of the
  port's render_block_fused on the host-built programs, and held against the
  reference's jitted render_horizon_onebuf (JAX on the CPU, gather fetch) at
  the render tolerances (tests/test_voice_render.py:214-217): voice peaks
  rtol 2e-6 / atol 1e-9, the bus outputs rtol 1e-5 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

from libzl_tpu.engine import render as ref_render
from libzl_tpu.ops import voice as ref_voice
from libzl_tpu_torch.engine import render as tr
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.ops import voice as tv

SR = 48000


def _tone(seconds, freq):
    t = np.arange(int(SR * seconds)) / SR
    return AudioData(
        (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None], SR)


def _play(eng, clip, note, channel, loop=True):
    cmd = ClipCommand.channel(clip.id, channel)
    cmd.midi_note = note
    cmd.change_volume = True
    cmd.volume = 0.8
    cmd.start_playback = True
    cmd.looping = loop
    cmd.change_looping = loop
    eng.schedule_clip_command(cmd, 0)


def horizon_fixture(B: int, H: int, V: int = 32):
    """(engine, packed [(prog_i, prog_f)] * H, dyn) from a port engine's
    host sim; the engine's pool ends at the horizon's end state."""
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      lookahead=0)
    eng.start_transport(bpm=120)
    clip = ClipAudioSource(eng, audio=_tone(0.5, 220.0))
    short = ClipAudioSource(eng, audio=_tone(0.05, 330.0))
    bq = ClipAudioSource(eng, audio=_tone(0.3, 110.0))
    bq.length_beats = 0.0   # a one-tick loop: several wraps per superblock
    _play(eng, clip, 60, 0)                 # steady loop
    _play(eng, short, 72, 1)                # short positional loop
    _play(eng, short, 72 if B == 128 else 84, 2, loop=False)  # dies
    _play(eng, bq, 50, 3)                   # beat-quantized loop
    for _ in range(2):
        eng.process_block()
    # a pending note-off on the build block: its release fixes rel_rate
    v = int(np.flatnonzero(eng.pool.active)[0])
    eng.pool.note_off(v, tail=True, frame_offset=7)
    pool, clock = eng.pool, eng.clock
    start0 = float(clock.sample_position)
    packed = []
    for h in range(H):
        prog = pool.build_program(
            block_start_sample=start0 + h * B,
            tick_anchor_sample=clock.anchor_sample,
            tick_anchor=clock.anchor_tick,
            samples_per_tick=clock.samples_per_tick,
            lane_enabled=eng.lane_enabled)
        packed.append(ref_voice.pack_program(prog))
        pool.advance(prog)
    dyn = ref_voice.pack_horizon_dynamics(packed[1:], pool.istart)
    assert dyn is not None
    return eng, packed, dyn


GEOMETRIES = [(128, 16), (1024, 4)]


def _fields(prog):
    out = {n: getattr(prog, n) for n in prog._fields if n != "env"}
    out.update({f"env.{n}": getattr(prog.env, n) for n in prog.env._fields})
    return out


@pytest.mark.parametrize("B,H", GEOMETRIES)
def test_horizon_programs_bit_equal_to_reference(B, H):
    _, packed, dyn = horizon_fixture(B, H)
    base = ref_voice.fuse_packed(*packed[0])
    want = ref_voice.horizon_programs(np, base, dyn, H, B)
    got = tv.horizon_programs(torch.from_numpy(base), torch.from_numpy(dyn),
                              H, B)
    assert len(got) == len(want) == H
    for h, (g, w) in enumerate(zip(got, want)):
        gf, wf = _fields(g), _fields(w)
        assert gf.keys() == wf.keys()
        for name, wv in wf.items():
            wv = np.asarray(wv)
            gv = gf[name].numpy()
            assert gv.dtype == wv.dtype, (h, name)
            assert gv.shape == wv.shape, (h, name)
            # bit patterns, so f32 columns compare bit for bit
            np.testing.assert_array_equal(
                gv.view(np.int32) if gv.dtype == np.float32 else gv,
                wv.view(np.int32) if wv.dtype == np.float32 else wv,
                err_msg=f"slice {h} {name}")
    # the fixture exercises what the encoding carries
    rf = np.stack([p[0][:, ref_voice.PI_RELEASE] for p in packed])
    assert (rf[1:] == int(ref_voice.RELEASE_NONE)).any()   # 16-bit sentinel
    assert (rf[0] == 7).any()                  # the build block's note-off
    stops = np.stack([p[0][:, ref_voice.PI_STOP] for p in packed[1:]])
    assert (stops < B).any()                               # mid-horizon death
    assert (dyn.shape[1] - 1) // (H - 1) == tv.horizon_dyn_cols(
        packed[0][0].shape[1] - ref_voice.PI_BQ)
    if B == 1024:
        bqs = np.stack([p[0][:, ref_voice.PI_BQ:] for p in packed[1:]])
        assert bqs.shape[2] > 0 and (bqs < B).any()        # bq columns


@pytest.mark.parametrize("B,H", GEOMETRIES)
def test_unpack_horizon_slice_rebuilds_active_rows(B, H):
    """Active rows of every rebuilt slice pack back to the host-built
    program column for column (the reference's own check, on tensors)."""
    _, packed, dyn = horizon_fixture(B, H)
    base = tv.unpack_program(*tv.split_fused(
        torch.from_numpy(ref_voice.fuse_packed(*packed[0]))))
    for h in range(1, H):
        rec = tv.unpack_horizon_slice(base, torch.from_numpy(dyn), h, B)
        pi, pf = packed[h]
        act = pi[:, ref_voice.PI_ACTIVE] != 0
        rec_np = rec._replace(
            env=rec.env._replace(**{n: getattr(rec.env, n).numpy()
                                    for n in rec.env._fields}),
            **{n: getattr(rec, n).numpy() for n in rec._fields
               if n != "env"})
        rpi, rpf = ref_voice.pack_program(rec_np)
        np.testing.assert_array_equal(pi[act], rpi[act], err_msg=f"{h} ints")
        np.testing.assert_array_equal(pf[act].view(np.int32),
                                      rpf[act].view(np.int32),
                                      err_msg=f"{h} floats")


def _inputs(B, H, fetch):
    eng, packed, dyn = horizon_fixture(B, H)
    sound = eng._sound_data_for_backend()[eng.mesh.devices[0]] \
        if fetch == "gather" else \
        torch.from_numpy(eng.bank.data.copy())
    strips = ref_voice.pack_strips(eng.strips)
    strips[3, 2] = -0.4                 # a panned channel strip
    return eng, packed, dyn, sound, torch.from_numpy(strips)


def _as_np(out):
    return {k: v.numpy() for k, v in out._asdict().items()}


@pytest.mark.parametrize("B,H", GEOMETRIES)
@pytest.mark.parametrize("fetch", ["gather", "windows"])
def test_horizon_renders_bit_equal_to_per_block(B, H, fetch):
    """onebuf, compact and fused horizons: each slice bit-equal to
    render_block_fused on that slice's host-built program; voice_peaks
    padded to the pool size."""
    eng, packed, dyn, sound, strips = _inputs(B, H, fetch)
    V = eng.pool.num_voices
    fused = [ref_voice.fuse_packed(*p) for p in packed]
    K = fused[0].shape[1]
    kw = dict(block_frames=B, slices=H, fetch=fetch, pad_voices_to=V + 8)
    hz = torch.from_numpy(np.concatenate([fused[0], dyn], axis=1))
    variants = {
        "onebuf": tr.render_horizon_onebuf(sound, hz, strips, base_cols=K,
                                           **kw),
        "compact": tr.render_horizon_compact(
            sound, torch.from_numpy(fused[0]), torch.from_numpy(dyn), strips,
            **kw),
        "fused": tr.render_horizon_fused(
            sound, torch.from_numpy(np.concatenate(fused, axis=1)), strips,
            **kw),
    }
    for h in range(H):
        want = _as_np(tr.render_block_fused(
            sound, torch.from_numpy(fused[h]), strips, block_frames=B,
            fetch=fetch, pad_voices_to=V + 8))
        for name, outs in variants.items():
            assert len(outs) == H
            got = _as_np(outs[h])
            for field, w in want.items():
                np.testing.assert_array_equal(
                    got[field], w, err_msg=f"{name} slice {h} {field}")
    assert variants["onebuf"][0].voice_peaks.shape == (V + 8,)
    assert np.abs(variants["onebuf"][H - 1].master.numpy()).max() > 0.01


@pytest.mark.parametrize("B,H", [(128, 4), (1024, 2)])
def test_horizon_onebuf_matches_jax(B, H):
    eng, packed, dyn, sound, strips = _inputs(B, H, "gather")
    V = eng.pool.num_voices
    base = ref_voice.fuse_packed(*packed[0])
    hz = np.concatenate([base, dyn], axis=1)
    want = ref_render.render_horizon_onebuf(
        sound.numpy(), hz, strips.numpy(), block_frames=B, slices=H,
        base_cols=base.shape[1], fetch="gather", pad_voices_to=V + 8)
    got = tr.render_horizon_onebuf(
        sound, torch.from_numpy(hz), strips, block_frames=B, slices=H,
        base_cols=base.shape[1], fetch="gather", pad_voices_to=V + 8)
    for h in range(H):
        g = _as_np(got[h])
        w = {k: np.asarray(v) for k, v in want[h]._asdict().items()}
        np.testing.assert_allclose(g["voice_peaks"], w["voice_peaks"],
                                   rtol=2e-6, atol=1e-9)
        for name in ("master", "lane_mix", "strip_dry", "strip_wet1",
                     "strip_wet2", "lane_peaks", "lane_rms", "master_peak"):
            assert g[name].shape == w[name].shape, name
            np.testing.assert_allclose(g[name], w[name], rtol=1e-5, atol=1e-7,
                                       err_msg=f"slice {h} {name}")
