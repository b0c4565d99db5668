"""Session save/load on the port (models/session.py, a copy of the
reference's), and across the two packages.

The JSON document (format version 1) is the state carried across: a session
saved by either package loads into an engine of the other, the loaded
engine saves the same document back (clip ids aside: each package numbers
its own clips), and the next 8 blocks of the restored engines, the same
notes started on each, agree under the whole-engine rule (master rtol 1e-5,
atol 2e-6 x the voices of the densest lane; tests/test_torch_engine.py).
Clip re-renders (speed, gain) use the numpy vocoder in both packages
(LIBZL_TPU_STRETCH=vocoder), the reference engines the numpy program
builder.
"""

import json

import numpy as np
import pytest
import torch

from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.io import wav as ref_wav
from libzl_tpu.midi.router import Destination as RefDestination
from libzl_tpu.models import clip as ref_clip
from libzl_tpu.models import session as ref_session
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io import wav as port_wav
from libzl_tpu_torch.midi.router import Destination
from libzl_tpu_torch.models import clip as port_clip
from libzl_tpu_torch.models import session as port_session

SR = 48000
V = 16
BLOCKS = 8


def ref_engine(sample_rate=SR):
    return RefEngine(sample_rate=sample_rate, backend="numpy", num_voices=V,
                     host_core="numpy")


def port_engine(sample_rate=SR):
    return AudioEngine("cpu", sample_rate=sample_rate, num_voices=V,
                       lookahead=0)


PACKAGES = {
    "ref": (ref_engine, ref_clip, ref_wav, ref_session, RefDestination),
    "port": (port_engine, port_clip, port_wav, port_session, Destination),
}


def build(kind, tmp_path):
    """An engine of package `kind` with a file-backed clip and an in-memory
    one, clip parameters, strips, a lane toggle, a routing entry, and the
    transport 40 blocks in."""
    make, clip_mod, wav_mod, _, dest = PACKAGES[kind]
    t = np.arange(SR // 2) / SR
    path = tmp_path / f"{kind}_src.wav"
    wav_mod.write_wav(path, (0.4 * np.sin(2 * np.pi * 220 * t))
                      .astype(np.float32), SR)
    eng = make()
    a = clip_mod.ClipAudioSource(eng, filepath=str(path))
    a.set_pan(-0.4)
    a.set_volume(-6.0)
    a.adsr_attack = 0.02
    a.keyzone_start, a.keyzone_end = 48, 72
    a.root_note = 57
    a.set_speed_ratio(1.25)
    mem = np.stack([0.3 * np.sin(2 * np.pi * 330 * t[:9000]),
                    0.2 * np.sin(2 * np.pi * 333 * t[:9000])], axis=1)
    b = clip_mod.ClipAudioSource(eng, audio=wav_mod.AudioData(
        mem.astype(np.float32), SR))
    b.set_looping(False)
    b.set_gain(-3.0)
    b.set_slices(4)
    eng.set_bpm(93)
    eng.set_strip(3, dry=0.7, pan=0.25)
    eng.lane_enabled[5] = False
    eng.router.set_channel_destination(2, dest.EXTERNAL, external_channel=7)
    eng.start_transport()
    for _ in range(40):
        eng.process_block()
    return eng


def document(path):
    """The saved JSON with each clip's package-local id dropped."""
    doc = json.loads(path.read_text())
    for c in doc["clips"]:
        del c["id"]
    return doc


def play_blocks(eng, clips):
    """Start the same notes on the restored clips, render BLOCKS blocks;
    returns the masters [BLOCKS*B, 2] and the densest lane's voices."""
    for ch, clip in enumerate(clips):
        clip.play(loop=True, midi_channel=ch)
    out, densest = [], 1
    for _ in range(BLOCKS):
        o = eng.process_block().outputs.master
        out.append(o.numpy() if torch.is_tensor(o) else np.asarray(o))
        act = eng.pool.active
        if act.any():
            densest = max(densest, int(np.bincount(eng.pool.lane[act]).max()))
    return np.concatenate(out), densest


@pytest.mark.parametrize("source", ["ref", "port"])
def test_session_loads_across_packages(source, tmp_path, monkeypatch):
    monkeypatch.setenv("LIBZL_TPU_STRETCH", "vocoder")
    src = build(source, tmp_path)
    saved = tmp_path / "take.zlsession"
    PACKAGES[source][3].save_session(src, saved)
    restored = {}
    for kind, (make, _, _, session_mod, _) in PACKAGES.items():
        eng = make()
        id_map = session_mod.load_session(eng, saved)
        again = tmp_path / f"{kind}_again.zlsession"
        session_mod.save_session(eng, again)
        assert document(again) == document(saved), kind
        restored[kind] = (eng, list(id_map.values()))
    port, port_clips = restored["port"]
    ref, ref_clips = restored["ref"]
    assert port.bpm == ref.bpm == 93
    assert port.router.outputs[2].destination == Destination.EXTERNAL
    for a, b in zip(port_clips, ref_clips):
        np.testing.assert_array_equal(a.playback_audio.samples,
                                      b.playback_audio.samples)
    got, d1 = play_blocks(port, port_clips)
    want, d2 = play_blocks(ref, ref_clips)
    assert int(port.clock.tick_position) == int(ref.clock.tick_position)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-6 * max(d1, d2))


def test_port_round_trip(tmp_path, monkeypatch):
    """tests/test_session.py's round trip on the port: clip parameters, an
    embedded in-memory clip, strips, lanes, routing, the transport position
    and the clip's looping flag come back, and the restored session plays."""
    monkeypatch.setenv("LIBZL_TPU_STRETCH", "vocoder")
    e1 = build("port", tmp_path)
    clips = list(e1.clips.values())
    saved_tick = int(e1.clock.tick_position)
    assert saved_tick > 0
    port_session.save_session(e1, tmp_path / "take.zlsession")
    e2 = port_engine()
    id_map = port_session.load_session(e2, tmp_path / "take.zlsession")
    assert len(id_map) == 2
    a, b = id_map[clips[0].id], id_map[clips[1].id]
    assert a.pan == clips[0].pan
    assert abs(a.volume_absolute - clips[0].volume_absolute) < 1e-9
    assert a.adsr_attack == 0.02
    assert (a.keyzone_start, a.keyzone_end, a.root_note) == (48, 72, 57)
    assert a.speed_ratio == 1.25
    np.testing.assert_array_equal(a.playback_audio.samples,
                                  clips[0].playback_audio.samples)
    np.testing.assert_array_equal(b.source.samples, clips[1].source.samples)
    assert b.get_looping() is False and b.gain_db == -3.0
    assert list(b.slice_positions) == list(clips[1].slice_positions)
    assert e2.bpm == 93
    assert e2.get_strip(3, "dry") == np.float32(0.7)
    assert not e2.lane_enabled[5]
    assert e2.router.outputs[2].external_channel == 7
    assert int(e2.clock.tick_position) == saved_tick and e2.transport_running
    master, _ = play_blocks(e2, [a])
    assert np.abs(master).max() > 0.01
    assert int(e2.clock.tick_position) > saved_tick


@pytest.mark.parametrize("source", ["ref", "port"])
def test_load_rejects_sample_rate_mismatch(source, tmp_path):
    """A session saved at 48 kHz does not load into a 44.1 kHz port
    engine: every seconds-based value would be retimed."""
    src = PACKAGES[source][0]()
    src.set_bpm(120)
    PACKAGES[source][3].save_session(src, tmp_path / "rate.zlsession")
    with pytest.raises(ValueError, match="44100"):
        port_session.load_session(port_engine(44100),
                                  tmp_path / "rate.zlsession")
