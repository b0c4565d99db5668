"""The benchmark's plain WSOLA (`zlbench/stretch.py`, NumPy alone) against
the port's clip render (`ops/resample.render_playback` on the native
`native/zl_stretch.cpp`, what `auto` resolves to where it builds).

They are held equal, bit for bit, with no tolerance: the library is built
with -O3 and no -march, so on x86-64 no product is fused into a sum; its
correlation's float32 products are exact in float64 and summed in order,
as the plain one sums them; its ties go to the first candidate scanned, as
`np.argmax` picks the first index; and every other step (downmix,
crossfade, resample, the lengths' rounding) is the same float32 or float64
operation in the same order. A library that cannot be built fails here
with its cause, as in test_torch_native.py: the benchmark's cell needs it.
"""

import numpy as np
import pytest

from libzl_tpu_torch import _native
from libzl_tpu_torch.ops import stretch_native
from libzl_tpu_torch.ops.resample import render_playback
from zlbench import stretch

SR = 48000
# the knob's extremes and inner steps: speed alone, pitch alone, both
SETTINGS = [(0.8, 0.0), (1.25, 0.0), (0.95, 0.0), (1.05, 0.0),
            (1.0, -12.0), (1.0, 12.0), (1.0, 1.0), (1.0, -5.0),
            (0.85, 7.0), (1.2, -3.0)]


@pytest.fixture(scope="module", autouse=True)
def native_stretcher():
    assert stretch_native.available(), _native.failure("zl_stretch")


def _clip(seed: int, channels: int) -> np.ndarray:
    """A clip as the benchmark makes them: partials and noise, 0.4-0.9 s."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(19_200, 43_200))
    t = np.arange(n) / SR
    f0 = rng.uniform(55.0, 880.0)
    x = sum(rng.uniform(0.05, 0.15) * np.sin(2 * np.pi * h * f0 * t
                                             + rng.uniform(0, 6.28))
            for h in (1, 2, 3))
    x = x[:, None] + rng.normal(0.0, 0.02, (n, channels))
    return x.astype(np.float32)


def _same(x: np.ndarray, speed: float, pitch: float) -> None:
    got = stretch.render_playback(x, speed, pitch, 0.0, SR)
    want = render_playback(x, speed_ratio=speed, pitch_semitones=pitch,
                           sample_rate=SR)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want), (speed, pitch, float(
        np.abs(got - want).max()))


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("seed", range(4))
def test_plain_wsola_is_the_programs_render(seed, channels):
    x = _clip(seed, channels)
    for speed, pitch in SETTINGS:
        _same(x, speed, pitch)


@pytest.mark.parametrize("speed,pitch", [(0.8, 0.0), (1.25, 5.0),
                                         (1.0, -12.0)])
def test_a_short_input_repeats_whole_frames(speed, pitch):
    """Under one sequence and two seeks (3,362 frames at 48 kHz) the
    stretcher repeats or drops whole frames."""
    x = _clip(7, 2)[:3000]
    seq, overlap, seek = stretch.wsola_params(SR)
    assert len(x) < seq + 2 * seek + 2
    _same(x, speed, pitch)


@pytest.mark.parametrize("speed,pitch", [(0.8, 0.0), (1.2, -4.0)])
def test_silence_and_ties_keep_the_first_candidate(speed, pitch):
    """Silence: every candidate's sum of squares is under 1e-12, every
    correlation the floor, and offset 0 stays. A wave of period 16 frames:
    the coarse scan's candidates are equal and the first one wins."""
    silent = np.zeros((40_000, 2), np.float32)
    silent[15_000:15_040] = 0.25
    _same(silent, speed, pitch)
    period = np.tile(np.float32([0.5, 0.25, -0.125, -0.5, 0.0, 0.375, -0.25,
                                 0.125, 0.5, -0.375, 0.25, -0.5, 0.125,
                                 0.0, -0.25, 0.375]), 2500)
    wave = np.stack([period, period[::-1]], axis=1)
    ref = wave[:384, :].mean(axis=1)
    windows = np.lib.stride_tricks.sliding_window_view(
        stretch._downmix(wave), 384)
    c = stretch._correlations(ref, windows[np.arange(1000, 1100, 16)])
    assert np.all(c == c[0])
    _same(wave, speed, pitch)


def test_lengths_round_as_the_library_does():
    lib = stretch_native.load()
    for n in (1, 2, 3, 1001, 48_000, 767_999):
        for f in (0.5, 0.8, 1.0 / 0.85, 1.25, 2.5, 1.0 / 1.15):
            assert stretch.out_len(n, f) == lib.zl_stretch_out_len(n, f)
    assert stretch.wsola_params(SR) == (1920, 384, 720)


@pytest.mark.parametrize("rate", [44100, 22050])
def test_other_rates_give_the_same_window(rate):
    """At 44.1 kHz the seek is 0.015 x 44100 = 661.5 frames before its
    rounding, which goes half away from zero."""
    x = _clip(3, 2)
    for speed, pitch in ((0.8, 0.0), (1.0, 4.0)):
        got = stretch.render_playback(x, speed, pitch, 0.0, rate)
        want = render_playback(x, speed_ratio=speed, pitch_semitones=pitch,
                               sample_rate=rate)
        assert np.array_equal(got, want)
