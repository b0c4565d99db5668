"""Audio output sinks: where the master mix goes.

The reference is audible because every SamplerChannel's JACK client connects
to system:playback_1/2 and the JACK server owns the soundcard
(lib/SamplerSynth.cpp:101-102). This build's pump renders blocks on a host
thread; a Sink is the playback_1/2 analog — the pump writes each consumed
block's master mix into the attached sink:

- NullSink   : discard (headless; keeps the pump timing-honest)
- FileSink   : stream to a WAV via the threaded DiskRecorder
- AlsaPcmSink: real audio out through libasound (gated — hosts without a
  sound stack raise at construction). Its blocking writei doubles as the
  block clock: when attached, the pump paces on sink backpressure instead
  of the wall clock, exactly how JACK paces the reference's callbacks.

Sinks receive float32 [frames, 2] blocks in order, exactly once (the pump's
block-sequence integrity test covers the delivery path).

A copy of libzl_tpu/io/sinks.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import alsa


class AudioSink:
    """One playback destination. `pacing` tells the pump whether write()
    blocks at the hardware rate (then wall-clock pacing is skipped)."""

    name = "sink"
    pacing = False

    def write(self, block: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(AudioSink):
    name = "null"

    def __init__(self):
        self.frames_written = 0

    def write(self, block: np.ndarray) -> None:
        self.frames_written += int(block.shape[0])


class FileSink(AudioSink):
    """Stream the master mix to a WAV file (threaded writer)."""

    name = "file"

    def __init__(self, path: str, sample_rate: int):
        from ..engine.recorder import DiskRecorder

        self._rec = DiskRecorder()
        self._rec.start(path, sample_rate)
        self.path = path

    @property
    def frames_written(self) -> int:
        return self._rec.frames_written

    def write(self, block: np.ndarray) -> None:
        self._rec.push(block)

    def close(self) -> None:
        self._rec.stop()


class AlsaPcmSink(AudioSink):
    """Playback through an ALSA PCM (float32 interleaved). write() blocks
    when the device buffer is full — the hardware paces the pump."""

    name = "alsa"
    pacing = True

    def __init__(self, device: str = "default", sample_rate: int = 48000,
                 channels: int = 2, latency_us: int = 40000):
        self._handle = alsa.pcm_open_playback(
            device, sample_rate, channels, latency_us
        )
        self.device = device
        self.frames_written = 0
        self._consecutive_failures = 0

    def write(self, block: np.ndarray) -> None:
        # a blocking writei can still return short after an xrun recovery
        # (interrupted write): retry the tail instead of dropping it —
        # a silent gap — while bounding the retries so a device that
        # persistently short-writes still reaches the failure fallback
        off = 0
        total = block.shape[0]
        for _ in range(4):
            n = alsa.pcm_write(self._handle, block[off:])
            self.frames_written += n
            off += n
            if off >= total or n == 0:
                break
        if off == 0:
            # device gone / persistent error: stop claiming to pace the
            # pump, or the render loop spins at full speed against a dead
            # write. The pump falls back to wall-clock pacing.
            self._consecutive_failures += 1
            if self._consecutive_failures >= 50:
                self.pacing = False
        else:
            self._consecutive_failures = 0

    def close(self) -> None:
        if self._handle is not None:
            alsa.pcm_drain_close(self._handle)
            self._handle = None


def make_sink(spec: str, sample_rate: int) -> AudioSink:
    """Build a sink from a spec string: "null", "file:<path>",
    "alsa[:<device>]" (LIBZL_TPU_SINK / CLI --sink syntax)."""
    kind, _, arg = spec.partition(":")
    if kind == "null":
        return NullSink()
    if kind == "file":
        if not arg:
            raise ValueError("file sink needs a path: file:<path>")
        return FileSink(arg, sample_rate)
    if kind == "alsa":
        return AlsaPcmSink(arg or "default", sample_rate)
    raise ValueError(f"unknown sink spec: {spec!r}")
