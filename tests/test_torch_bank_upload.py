"""The sound bank's region-only upload (engine/engine.py
`_sound_data_for_backend`).

While the capacity holds and the engine recorded every mutation since the
device's version (`register_clip`, `reload_clip_sound`, `unregister_clip`),
only the frames those wrote are converted and copied into the device
tensors, in place. After any sequence of loads, replaces (the region
reused or a new one appended) and unloads the device bank is torch.equal
to a full conversion of `bank.data`, in both layouts (planar for the
windows fetch, interleaved for the gather) and both bank dtypes. A growth
makes a new device bank and captures every graph again: after recorded
mutations the old bank is copied into it on the device and only the
written regions come from the host; after a version change the engine did
not record, the whole bank is uploaded. Such a change within the capacity
converts the whole capacity, in place.
"""

import numpy as np
import pytest
import torch

from libzl_tpu_torch import convert
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.engine.soundbank import SoundBank
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource

SR = 48000
B = 128


def _audio(frames: int, seed: int) -> AudioData:
    rng = np.random.default_rng(seed)
    return AudioData(rng.uniform(-0.9, 0.9, (frames, 2)).astype(np.float32),
                     SR)


def _engine(fetch: str, bank_dtype: str) -> AudioEngine:
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=16,
                      lookahead=0, fetch=fetch, bank_dtype=bank_dtype)
    eng.bank = SoundBank(capacity_frames=1 << 16,
                         tail_guard=eng.bank._tail_guard)
    return eng


def _device_bank(eng) -> torch.Tensor:
    (t,) = eng._sound_data_for_backend().values()
    return t


def _full(eng) -> torch.Tensor:
    layout = "planar" if eng.fetch == "windows" else "interleaved"
    return torch.from_numpy(convert.sound_bank_array(
        eng.bank.data, eng.bank_dtype, layout))


def _counts(eng) -> tuple:
    s = eng.stats()
    return (s["bank_uploads_full"], s["bank_uploads_partial"],
            s["bank_upload_bytes"])


@pytest.mark.parametrize("bank_dtype", ["float32", "int16"])
@pytest.mark.parametrize("fetch", ["windows", "gather"])
def test_region_upload_equals_a_full_upload(fetch, bank_dtype):
    eng = _engine(fetch, bank_dtype)
    item = 2 if bank_dtype == "int16" else 4
    a = ClipAudioSource(eng, audio=_audio(3000, 1))
    b = ClipAudioSource(eng, audio=_audio(2000, 2))
    a.play(loop=True, midi_channel=0)
    b.play(loop=True, midi_channel=1)
    eng.start_transport(bpm=120)
    eng.process_block()
    bank = _device_bank(eng)
    assert torch.equal(bank, _full(eng))
    assert _counts(eng)[:2] == (1, 0)

    steps = [
        # a shorter render reuses a's region
        lambda: _reload(eng, a, _audio(1500, 3)),
        # a longer one appends a region for b
        lambda: _reload(eng, b, _audio(4000, 4)),
        # a new clip, then an unload (which writes no frame)
        lambda: ClipAudioSource(eng, audio=_audio(500, 5)).slot,
        lambda: eng.unregister_clip(a),
    ]
    for step in steps:
        full0, part0, bytes0 = _counts(eng)
        edits = step()
        eng.process_block()
        assert _device_bank(eng) is bank       # in place: no new device bank
        assert torch.equal(bank, _full(eng))
        full1, part1, bytes1 = _counts(eng)
        assert (full1, part1) == (full0, part0 + 1)
        frames = 0 if edits is None else edits.padded_length
        assert bytes1 - bytes0 == frames * 2 * item


def _reload(eng, clip, audio):
    clip.playback_audio = audio
    eng.reload_clip_sound(clip)
    return clip.slot


@pytest.mark.parametrize("fetch", ["windows", "gather"])
def test_two_edits_before_an_upload_merge(fetch):
    eng = _engine(fetch, "float32")
    a = ClipAudioSource(eng, audio=_audio(3000, 1))
    ClipAudioSource(eng, audio=_audio(2000, 2))
    a.play(loop=True, midi_channel=0)
    eng.start_transport(bpm=120)
    eng.process_block()
    bytes0 = _counts(eng)[2]
    _reload(eng, a, _audio(2500, 6))
    slot = _reload(eng, a, _audio(2800, 7))   # the same region twice
    eng.process_block()
    assert torch.equal(_device_bank(eng), _full(eng))
    assert _counts(eng)[1:] == (1, bytes0 + slot.padded_length * 2 * 4)


@pytest.mark.parametrize("fetch", ["windows", "gather"])
def test_growth_and_unrecorded_changes_upload_the_whole_bank(fetch):
    eng = _engine(fetch, "float32")
    ClipAudioSource(eng, audio=_audio(3000, 1))
    eng.warmup()
    bank = _device_bank(eng)
    graphs = eng.stats()["graphs"]
    assert graphs > 0
    # the engine never saw this load: the whole capacity, in place
    eng.bank.load(_audio(1000, 8))
    eng.process_block()
    assert _device_bank(eng) is bank
    assert torch.equal(bank, _full(eng))
    assert _counts(eng)[:2] == (2, 0)
    # unrecorded, and the capacity doubles: a new bank from the whole of
    # bank.data, every graph again
    eng.bank.load(_audio(1 << 16, 9))
    eng.process_block()
    grown = _device_bank(eng)
    assert grown is not bank
    assert torch.equal(grown, _full(eng))
    stats = eng.stats()
    assert stats["bank_uploads_full"] == 3
    assert stats["bank_uploads_partial"] == 0
    assert stats["graph_recaptures"] == graphs
    # and after it, region uploads again
    ClipAudioSource(eng, audio=_audio(700, 10))
    eng.process_block()
    assert _device_bank(eng) is grown
    assert torch.equal(grown, _full(eng))
    assert eng.stats()["bank_uploads_partial"] == 1


@pytest.mark.parametrize("bank_dtype", ["float32", "int16"])
@pytest.mark.parametrize("fetch", ["windows", "gather"])
def test_a_recorded_growth_copies_the_bank_on_the_device(fetch, bank_dtype,
                                                        monkeypatch):
    eng = _engine(fetch, bank_dtype)
    item = 2 if bank_dtype == "int16" else 4
    a = ClipAudioSource(eng, audio=_audio(3000, 1))
    a.play(loop=True, midi_channel=0)
    eng.start_transport(bpm=120)
    eng.warmup()
    bank = _device_bank(eng)
    graphs = eng.stats()["graphs"]
    assert graphs > 0
    cap0 = eng.bank.capacity_frames
    full0, part0, bytes0 = _counts(eng)
    # a region rewritten, then a render longer than the capacity's rest:
    # the bank doubles inside replace(), both edits recorded
    _reload(eng, a, _audio(2000, 11))
    slot = _reload(eng, a, _audio(cap0, 12))
    assert eng.bank.capacity_frames > cap0
    # new memory holds what it held before: the grown bank's every frame
    # must be written
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: empty(*a, **k).fill_(7))
    eng.process_block()
    monkeypatch.undo()
    grown = _device_bank(eng)
    assert grown is not bank
    assert torch.equal(grown, _full(eng))
    full1, part1, bytes1 = _counts(eng)
    assert (full1, part1) == (full0, part0 + 1)
    # from the host only a's first region and the appended one, which
    # follows it: [0, the appended region's end)
    assert slot.base == 3000 + 8
    assert bytes1 - bytes0 == (slot.base + slot.padded_length) * 2 * item
    assert eng.stats()["graph_recaptures"] == graphs


def test_a_region_upload_renders_as_a_full_one():
    """Two engines, the same session and re-renders: one refreshes its bank
    by regions, the other converts the whole capacity at every version
    (its edits forgotten); their blocks are bit-equal."""
    outs = []
    for forget in (False, True):
        eng = _engine("windows", "float32")
        clips = [ClipAudioSource(eng, audio=_audio(n, s))
                 for s, n in enumerate((4000, 2500, 6000))]
        for ch, c in enumerate(clips):
            c.play(loop=True, midi_channel=ch)
        eng.start_transport(bpm=120)
        masters = []
        for blk in range(40):
            if blk in (5, 17, 29):
                c = clips[blk % 3]
                _reload(eng, c, _audio(2000 + 300 * blk, 100 + blk))
            if forget:
                eng._bank_edits.append((-2, -2, 0, 0))   # breaks the chain
            masters.append(eng.process_block().outputs.master.clone())
        stats = eng.stats()
        assert stats["bank_uploads_partial"] == (0 if forget else 3)
        outs.append(torch.stack(masters))
    assert torch.equal(outs[0], outs[1])
