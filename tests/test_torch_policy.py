"""The engine's dispatch defaults, resolved per device, on the CPU.

"auto" resolves on "cuda" by the rules measured on an H100 (PERF.md §5,
`chip_smoke.py --policy-only`): the lookahead H by `_card_lookahead`, the
bridge's bounce drain by its resolver. On the CPU
every option resolves as the reference's jax engine and bridge do. A
horizon is bit-equal to the per-block path, so each H the card's rule can
return is run here against the same engine at lookahead=0.
"""

import numpy as np
import pytest

from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu_torch.capi.bridge import resolve_bounce_drain
from libzl_tpu_torch.engine import engine as engine_mod
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine, resolve_lookahead
from libzl_tpu_torch.engine.graphs import DISPATCH_SPANS
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource

SR = 48000

# "auto" on a card: B -> H (PERF.md §5, the sweeps' decision at B = 128,
# 256 and 1024; elsewhere the nearer measured B on a log scale)
CARD_LOOKAHEAD = {32: 16, 64: 16, 128: 16, 256: 0, 512: 0, 1024: 0,
                  2048: 0, 4096: 0, 10240: 0, 16512: 0}
CARD_DRAIN = 64


@pytest.mark.parametrize("B", sorted(CARD_LOOKAHEAD))
def test_card_lookahead_follows_the_measured_table(B):
    assert engine_mod._card_lookahead(B) == CARD_LOOKAHEAD[B]
    assert resolve_lookahead("auto", B, "cuda") == CARD_LOOKAHEAD[B]


@pytest.mark.parametrize("B", sorted(CARD_LOOKAHEAD))
def test_cpu_lookahead_resolves_as_the_reference(B):
    """The CPU keeps the reference's jax engine's "auto" (a 2048-frame
    window), whatever the card's rule says."""
    ref = RefEngine(sample_rate=SR, block_frames=B, num_voices=8,
                    backend="jax", host_core="numpy")
    assert resolve_lookahead("auto", B, "cpu") == ref._lookahead


def test_card_table_matches_what_chip_smoke_checks_on_the_card():
    import chip_smoke

    for B, H in chip_smoke.CARD_LOOKAHEAD.items():
        assert resolve_lookahead("auto", B, "cuda") == H
    assert chip_smoke.CARD_DRAIN == CARD_DRAIN


@pytest.mark.parametrize("B,H", [(1, 16), (100, 16), (181, 16), (182, 0),
                                 (192, 0)])
def test_card_lookahead_edge(B, H):
    """A B between the measured 128 and 256 takes the nearer one's
    decision on a log scale (sqrt(128 * 256) ~ 181); below 128, 128's."""
    assert resolve_lookahead("auto", B, "cuda") == H


def test_card_lookahead_is_defined_for_every_block_size():
    """Every B the engine accepts gets an H: never 1 (that is the
    per-block path, 0), never more than 16, never negative."""
    for B in range(1, 20000, 7):
        H = resolve_lookahead("auto", B, "cuda")
        assert H != 1 and 0 <= H <= 16


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("value,want", [(0, 0), (1, 0), (2, 2), (-3, 0),
                                        ("8", 8)])
def test_explicit_lookahead_is_taken_as_given(device, value, want):
    assert resolve_lookahead(value, 1024, device) == want


@pytest.mark.parametrize("value,device,want", [
    ("auto", "cuda", CARD_DRAIN), ("auto", "cpu", 1), (8, "cuda", 8),
    ("16", "cpu", 16), (0, "cuda", 1), (64, "cpu", 64)])
def test_bounce_drain_resolution(value, device, want):
    assert resolve_bounce_drain(value, device) == want


def _tone(seconds=0.5, freq=220.0):
    t = np.arange(int(SR * seconds)) / SR
    return AudioData(
        (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None], SR)


def _play(eng, clip, note, channel):
    cmd = ClipCommand.channel(clip.id, channel)
    cmd.midi_note = note
    cmd.change_volume = True
    cmd.volume = 0.8
    cmd.start_playback = True
    cmd.looping = True
    cmd.change_looping = True
    eng.schedule_clip_command(cmd, 0)


def _session(lookahead, blocks=72):
    """A short CPU session at B=64: three looped notes, a fourth note at
    block 30 (mid-horizon) and a strip change at block 50; every block's
    master and voice peaks."""
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=64, num_voices=16,
                      lookahead=lookahead)
    clip = ClipAudioSource(eng, audio=_tone())
    eng.start_transport(bpm=120)
    for note, ch in ((60, 0), (64, 1), (67, 2)):
        _play(eng, clip, note, ch)
    outs = []
    for i in range(blocks):
        if i == 30:
            _play(eng, clip, 72, 3)
        if i == 50:
            eng.set_strip(1, dry=0.6, pan=0.3)
        o = eng.process_block().outputs
        outs.append((o.master.numpy().copy(), o.voice_peaks.numpy().copy()))
    eng.drain_speculation()
    return outs, eng.render_dispatches["horizon"]


@pytest.mark.parametrize("H", sorted(set(CARD_LOOKAHEAD.values())))
def test_each_card_horizon_is_bit_equal_to_per_block(H):
    """Every H the card's rule returns renders the per-block engine's
    bits (the horizon simulates the host's own per-block advance)."""
    (got, horizons), (want, _) = _session(H), _session(0)
    assert (horizons > 0) == (H > 0)
    master = np.concatenate([m for m, _ in got])
    assert np.abs(master).max() > 0.05
    for (gm, gp), (wm, wp) in zip(got, want):
        assert np.array_equal(gm, wm) and np.array_equal(gp, wp)


def test_graph_replay_records_its_dispatch_parts():
    """A graph engine's replays record each part of the dispatch span
    (DISPATCH_SPANS) once a render; the parts sum to less than it."""
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=128, num_voices=16,
                      lookahead=0, render_graphs="auto")
    clip = ClipAudioSource(eng, audio=_tone())
    eng.start_transport(bpm=120)
    _play(eng, clip, 60, 0)
    eng.warmup()
    for _ in range(12):
        eng.process_block()
    prof = eng.profiler.summary()
    replays = eng.stats()["graph_replays"]
    assert replays >= 11
    for name in DISPATCH_SPANS:
        assert prof[name]["count"] == replays, name
    parts = sum(prof[name]["p50_ms"] for name in DISPATCH_SPANS)
    assert parts <= prof["dispatch"]["max_ms"]
