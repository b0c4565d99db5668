"""Audio input sources: feed the capture path.

The reference's AudioLevels taps JACK's system capture ports for metering
and recording (the SystemCapture client, lib/AudioLevels.cpp:279-299,
IDX 0 of the meter layout) — capture audio is observed/recorded, not mixed
into playback. This module is the sink mirror (io/sinks.py): the pump pulls
one block per cycle from the attached source and feeds it to the engine's
capture meters and any capture recorder.

- NullSource   : silence (keeps the capture slot defined on headless hosts)
- FileSource   : stream a WAV (looped or one-pass) — deterministic tests,
                 re-amping workflows
- AlsaPcmSource: real capture through libasound (gated on the library)

A copy of libzl_tpu/io/sources.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import alsa


class AudioSource:
    name = "source"

    def read(self, frames: int) -> np.ndarray:
        """Return float32 [frames, 2]; silence-pad if underrun."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSource(AudioSource):
    name = "null"

    def read(self, frames: int) -> np.ndarray:
        return np.zeros((frames, 2), np.float32)


class FileSource(AudioSource):
    name = "file"

    def __init__(self, path: str, loop: bool = True,
                 engine_rate: int = 0):
        from .wav import read_audio, to_stereo

        audio = read_audio(path)
        # one channel-normalization policy (io/wav.to_stereo), not a copy
        # that can drift from it
        data = np.ascontiguousarray(to_stereo(audio.samples), np.float32)
        # a capture file at a different rate would otherwise be consumed
        # sample-for-sample — silently pitch/speed-shifted audio
        if engine_rate and audio.sample_rate != engine_rate and len(data):
            ratio = engine_rate / audio.sample_rate
            m = int(round(len(data) * ratio))
            xi = np.arange(m) / ratio
            x0 = np.arange(len(data), dtype=np.float64)
            data = np.stack(
                [np.interp(xi, x0, data[:, c]) for c in range(2)], axis=1
            ).astype(np.float32)
        self._data = data
        self._pos = 0
        self.loop = loop
        self.sample_rate = engine_rate or audio.sample_rate

    def read(self, frames: int) -> np.ndarray:
        n = self._data.shape[0]
        out = np.zeros((frames, 2), np.float32)
        if n == 0:
            return out  # zero-frame file: silence (never spin)
        done = 0
        while done < frames:
            if self._pos >= n:
                if not self.loop:
                    break
                self._pos = 0
            take = min(frames - done, n - self._pos)
            out[done : done + take] = self._data[self._pos : self._pos + take]
            self._pos += take
            done += take
        return out


class AlsaPcmSource(AudioSource):
    """Capture from an ALSA PCM (float32 interleaved, non-blocking-ish:
    underruns return silence)."""

    name = "alsa"

    def __init__(self, device: str = "default", sample_rate: int = 48000,
                 channels: int = 2, latency_us: int = 40000):
        self._handle = alsa.pcm_open_capture(
            device, sample_rate, channels, latency_us
        )
        self.device = device
        self._channels = channels

    def read(self, frames: int) -> np.ndarray:
        from .wav import to_stereo

        block = alsa.pcm_read(self._handle, frames, self._channels)
        if block.shape[0] < frames:
            block = np.pad(block, ((0, frames - block.shape[0]), (0, 0)))
        # a mono capture device must still honor the read() contract
        # (float32 [frames, 2]) — duplicate like every other source
        return to_stereo(block).astype(np.float32, copy=False)

    def close(self) -> None:
        if self._handle is not None:
            alsa.pcm_close(self._handle)
            self._handle = None


def make_source(spec: str, sample_rate: int) -> AudioSource:
    """"null", "file:<path>", "alsa[:<device>]"."""
    kind, _, arg = spec.partition(":")
    if kind == "null":
        return NullSource()
    if kind == "file":
        if not arg:
            raise ValueError("file source needs a path: file:<path>")
        return FileSource(arg, engine_rate=sample_rate)
    if kind == "alsa":
        return AlsaPcmSource(arg or "default", sample_rate)
    raise ValueError(f"unknown source spec: {spec!r}")
