"""The port's accelerator vocoder (ops/stretch_torch) on the CPU, against
the reference's (ops/stretch_jax) and the numpy oracle (ops/resample).

Every case of tests/test_stretch_jax.py runs on the port with
device="cpu": duration, pitch, amplitude, identity, click-train onsets, the
short input, the scatter path (fft_size=1500, hop=490), backend resolution
from LIBZL_TPU_STRETCH (`torch`, and `jax`, the reference's name), the clip's
render_playback and its deferred re-render through a port engine.
`time_stretch_torch` is held to `time_stretch_jax` on the same seeded input
at a max abs error of 1e-3 x the output's peak over the whole output: the
same algorithm in float32 on two FFT libraries. Its measured worst over
seeds 0-3 of this input is 4.7e-4 x the peak, at the tail where the window
normalisation is smallest; the reference's own rule against the numpy path
is 2% away from the edges (tests/test_stretch_jax.py:47-57).
"""

import time

import numpy as np
import pytest
import torch

from libzl_tpu.ops.stretch_jax import time_stretch_jax
from libzl_tpu_torch.ops import resample
from libzl_tpu_torch.ops.stretch_torch import time_stretch_torch

SR = 48000.0
CPU = dict(device="cpu")


def tone(freq=440.0, seconds=1.0, sr=SR, stereo=False):
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    if stereo:
        return np.stack([x, 0.8 * x], axis=1)
    return x[:, None]


def dominant_freq(x, sr=SR):
    x = x[:, 0] if x.ndim == 2 else x
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(np.fft.rfftfreq(len(x), 1 / sr)[sp.argmax()])


def seeded_input(channels: int, seed: int = 0) -> np.ndarray:
    """Half a second of three random partials per channel plus a little
    noise, from `seed`."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(0.5 * SR)) / SR
    cols = []
    for _ in range(channels):
        f = rng.uniform(80, 2000, 3)[:, None]
        ph = rng.uniform(0, 2 * np.pi, 3)[:, None]
        a = rng.uniform(0.05, 0.3, 3)[:, None]
        cols.append((a * np.sin(2 * np.pi * f * t + ph)).sum(0)
                    + 0.02 * rng.standard_normal(t.size))
    return np.stack(cols, axis=1).astype(np.float32)


@pytest.mark.parametrize("fft_size,hop", [(2048, 512), (1500, 490)])
@pytest.mark.parametrize("factor", [0.5, 1.37, 2.0])
@pytest.mark.parametrize("channels", [1, 2])
def test_matches_reference_vocoder(channels, factor, fft_size, hop):
    """Both overlap-add paths: the reshape path (hop | fft_size) and the
    reference's scatter path, which the port runs as the reshape loop over
    ceil(fft/hop) zero-padded phases."""
    x = seeded_input(channels)
    got = time_stretch_torch(x, factor, fft_size, hop, **CPU)
    want = time_stretch_jax(x, factor, fft_size, hop)
    assert got.shape == want.shape == (int(round(x.shape[0] * factor)),
                                       channels)
    assert got.dtype == np.float32
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * peak


@pytest.mark.parametrize("factor", [0.5, 0.75, 1.5, 2.0])
def test_duration_matches_numpy_vocoder(factor):
    x = tone(330.0, 0.7)
    yt = time_stretch_torch(x, factor, **CPU)
    yn = resample.time_stretch(x, factor)
    assert yt.shape == yn.shape == (int(round(x.shape[0] * factor)), 1)


@pytest.mark.parametrize("factor", [0.5, 1.5, 2.0])
def test_pitch_preserved(factor):
    y = time_stretch_torch(tone(440.0), factor, **CPU)
    assert dominant_freq(y) == pytest.approx(440.0, abs=6.0)


def test_matches_numpy_vocoder_closely():
    """The reference's rule against the numpy oracle: within 2% of the peak
    away from the fade-in/out edges."""
    x = tone(261.6, 0.6, stereo=True)
    yt = time_stretch_torch(x, 1.37, **CPU)
    yn = resample.time_stretch(x, 1.37)
    a, b = 4096, yt.shape[0] - 4096
    err = np.abs(yt[a:b] - yn[a:b]).max()
    assert err < 0.02 * np.abs(yn[a:b]).max()


def test_amplitude_preserved():
    y = time_stretch_torch(tone(220.0, 0.8), 1.5, **CPU)
    assert np.abs(y[8192:-8192, 0]).max() == pytest.approx(0.5, rel=0.1)


def test_identity_is_exact():
    x = tone(440.0, 0.3)
    np.testing.assert_array_equal(time_stretch_torch(x, 1.0, **CPU), x)


def test_click_train_transients():
    """Onset reset: clicks stay clicks."""
    sr = int(SR)
    x = np.zeros((sr // 2, 1), np.float32)
    for k in range(0, sr // 2, 6000):
        x[k:k + 32, 0] = 1.0
    env = np.abs(time_stretch_torch(x, 2.0, **CPU)[:, 0])
    groups = np.diff(np.flatnonzero(env > 0.35), prepend=-10)
    assert abs(int((groups > 1000).sum())
               - len(range(0, sr // 2, 6000))) <= 2


def test_short_input_and_non_divisible_hop():
    short = tone(440.0, 0.01)  # 480 frames < fft_size 2048
    out = time_stretch_torch(short, 2.0, **CPU)
    assert out.shape[0] == round(short.shape[0] * 2.0)
    assert np.isfinite(out).all()
    x = tone(440.0, 0.4)
    out = time_stretch_torch(x, 1.5, fft_size=1500, hop=490, **CPU)
    assert out.shape[0] == round(x.shape[0] * 1.5)
    assert abs(dominant_freq(out) - 440.0) < 6.0


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_env_backend_resolution(monkeypatch, name):
    """LIBZL_TPU_STRETCH=torch, or the reference's `jax`, selects the
    accelerator vocoder on LIBZL_TPU_BACKEND's device; explicit choices
    ignore the variable."""
    monkeypatch.setenv("LIBZL_TPU_STRETCH", name)
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "cpu")
    assert resample.resolve_stretch_backend("auto") == "torch"
    assert resample.resolve_stretch_backend(name) == "torch"
    assert resample.resolve_stretch_backend("vocoder") == "vocoder"
    x = tone(392.0, 0.5)
    y = resample.stretch(x, 1.25, backend="auto")
    np.testing.assert_array_equal(y, time_stretch_torch(x, 1.25, **CPU))
    assert y.shape[0] == int(round(x.shape[0] * 1.25))
    assert dominant_freq(y) == pytest.approx(392.0, abs=6.0)
    with pytest.raises(ValueError, match="'torch' or 'jax'"):
        resample.resolve_stretch_backend("tpu")


def test_torch_backend_never_falls_back_to_the_host(monkeypatch):
    """LIBZL_TPU_STRETCH=torch with the default device ("cuda") raises
    without a card; a bad LIBZL_TPU_BACKEND raises naming it."""
    monkeypatch.setenv("LIBZL_TPU_STRETCH", "torch")
    monkeypatch.delenv("LIBZL_TPU_BACKEND", raising=False)
    x = tone(440.0, 0.2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resample.stretch(x, 1.5)
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "numpy")
    with pytest.raises(ValueError, match="LIBZL_TPU_BACKEND"):
        resample.stretch(x, 1.5)


def test_render_playback_via_torch(monkeypatch):
    monkeypatch.setenv("LIBZL_TPU_STRETCH", "torch")
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "cpu")
    x = tone(440.0, 0.5)
    out = resample.render_playback(x, speed_ratio=0.5, gain_db=-6.0)
    assert out.shape[0] == int(round(x.shape[0] * 2.0))
    mid = out[8192:-8192, 0]
    assert np.abs(mid).max() == pytest.approx(0.5 * 10 ** (-6 / 20), rel=0.15)


def test_deferred_rerender_uses_torch_backend(monkeypatch):
    """A clip speed change under a port engine re-renders on the clip's
    worker thread through the torch vocoder, and the playback buffer it
    hands back is the vocoder's output (numpy)."""
    from libzl_tpu_torch.engine.commands import ClipCommand
    from libzl_tpu_torch.engine.engine import AudioEngine
    from libzl_tpu_torch.io.wav import AudioData
    from libzl_tpu_torch.models.clip import ClipAudioSource

    monkeypatch.setenv("LIBZL_TPU_STRETCH", "torch")
    monkeypatch.setenv("LIBZL_TPU_BACKEND", "cpu")
    sr = 48000
    engine = AudioEngine("cpu", sample_rate=sr, num_voices=8, lookahead=0)
    t = np.arange(sr * 2) / sr
    wave = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[:, None]
    clip = ClipAudioSource(engine, audio=AudioData(wave, sr))
    engine.start_transport(bpm=120)
    changed = []
    clip.playback_changed_callback = lambda: changed.append(True)
    cmd = ClipCommand.channel(clip.id, 0)
    cmd.midi_note = 60
    cmd.change_speed = True
    cmd.speed_ratio = 0.5
    engine.schedule_clip_command(cmd, 0)
    deadline = time.monotonic() + 30.0
    while not changed and time.monotonic() < deadline:
        engine.process_block()
        time.sleep(0.01)
    assert changed, "deferred torch render never landed"
    got = clip.playback_audio.samples
    assert isinstance(got, np.ndarray)
    assert got.shape[0] == pytest.approx(2 * sr * 2, abs=4)
    np.testing.assert_array_equal(got, time_stretch_torch(wave, 2.0, **CPU))
    clip.destroy()
