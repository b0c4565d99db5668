"""The benchmark's inputs, all drawn from `--seed`: the sketchpad's clips,
its looped voices and the live note stream.

`loop_plan` is a copy of libzl_tpu_torch/bench.py::session_plan's voice
plan, frozen here and drawn from the run's seed: voice v plays clip
v % clips on channel v % channels, note 48 + (v // 320) * 5 + U{0..4} (so no
two voices of one clip and channel share a note and their start commands
never coalesce), volume U(0.3, 1.0). The clips are stereo loops of whole
bars (the config's `clip_bars`, each length held by the same number of
clips whatever the seed, in an order the seed draws), made of three
partials and noise. The note stream is the one general generator of every
traffic mix: its parameters are the mix's file (`traffic/<name>.json`).

Nothing here imports the port: the harness hands these plain inputs to the
program and to the reference alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_CHANNELS = 10          # the sketchpad's channels 1..10 (lanes 2..11)


@dataclasses.dataclass
class Clip:
    """One clip's audio: float32 [frames, 2], and its length in bars."""

    audio: np.ndarray
    bars: int


@dataclasses.dataclass
class LoopVoice:
    clip: int
    channel: int
    note: int
    volume: float


@dataclasses.dataclass
class Note:
    """One live note: on before block `on_block` of the window, off before
    block `off_block` (block indices from the window's first block)."""

    channel: int
    pitch: int
    velocity: int
    on_block: int
    off_block: int


def bar_frames(config: dict) -> int:
    beats_per_bar = 4
    return int(round(config["sample_rate"] * 60.0 / config["bpm"]
                     * beats_per_bar))


def make_clips(config: dict, seed: int, device) -> list:
    """The sketchpad's clips from the seed: `clips` stereo loops whose bar
    counts repeat `clip_bars` evenly (so every seed holds the same audio
    length) in a seed-drawn order; each channel is three partials of a
    seed-drawn fundamental plus Gaussian noise, made on `device` in one
    pass and returned as host float32 arrays."""
    n = int(config["clips"])
    bars_cycle = [int(b) for b in config["clip_bars"]]
    rng = np.random.default_rng([seed, 1])
    bars = np.array([bars_cycle[i % len(bars_cycle)] for i in range(n)])
    bars = bars[rng.permutation(n)]
    frames = bars * bar_frames(config)
    sr = float(config["sample_rate"])
    f0 = np.exp(rng.uniform(np.log(55.0), np.log(880.0), n))
    amps = rng.uniform(0.05, 0.15, (n, 3))
    phase = rng.uniform(0.0, 2 * np.pi, (n, 2, 3))
    noise = rng.uniform(0.01, 0.05, n)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    total = int(frames.sum())
    idx = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.as_tensor(frames, device=dev))
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(frames)[:-1]]),
                             device=dev)
    t = (torch.arange(total, device=dev, dtype=torch.float64)
         - starts[idx].double()) / sr
    f0_t = torch.as_tensor(f0, device=dev)[idx]
    out = torch.empty((total, 2), dtype=torch.float32, device=dev)
    for ch in range(2):
        acc = torch.zeros(total, dtype=torch.float64, device=dev)
        for h in range(3):
            a = torch.as_tensor(amps[:, h], device=dev)[idx]
            ph = torch.as_tensor(phase[:, ch, h], device=dev)[idx]
            acc += a * torch.sin(2 * np.pi * (h + 1) * f0_t * t + ph)
        sigma = torch.as_tensor(noise, device=dev)[idx]
        acc += sigma * torch.randn(total, dtype=torch.float64, device=dev,
                                   generator=gen)
        out[:, ch] = acc.float()
    host = out.cpu().numpy()
    clips, off = [], 0
    for i in range(n):
        clips.append(Clip(host[off:off + frames[i]], int(bars[i])))
        off += frames[i]
    return clips


def loop_plan(count: int, num_clips: int, seed: int) -> list:
    """`count` looped voices: the bench's session_plan, from the seed."""
    rng = np.random.default_rng([seed, 2])
    voices = []
    for v in range(count):
        note = 48 + (v // 320) * 5 + int(rng.integers(0, 5))
        volume = float(rng.uniform(0.3, 1.0))
        voices.append(LoopVoice(v % num_clips, v % NUM_CHANNELS, note,
                                volume))
    return voices


def keys_clip(channel: int, num_clips: int) -> int:
    """The clip a sampler channel plays its live notes from: of the other
    parity than the channel, so that no looped voice shares its (clip,
    channel) pair (voice v plays clip v % clips on channel v % 10: with an
    even clip count such a pair has one parity) and a note-off never
    releases a loop."""
    return (7 * channel + 1) % num_clips


def note_stream(notes: dict, seconds: float, period_s: float,
                seed: int) -> list:
    """The live notes of a window of `seconds`: round(rate_hz * seconds)
    note-ons at uniform times (a Poisson stream given its count), each on a
    uniform channel and pitch, with a velocity and a gate drawn uniformly;
    block indices on the period grid. The count and the distributions are
    the same for every seed."""
    rng = np.random.default_rng([seed, 3])
    n = int(round(float(notes["rate_hz"]) * seconds))
    times = np.sort(rng.uniform(0.0, seconds, n))
    lo, hi = notes["pitch"]
    vlo, vhi = notes["velocity"]
    glo, ghi = notes["gate_ms"]
    out = []
    for t in times:
        gate = rng.uniform(glo, ghi) / 1e3
        on = int(t // period_s)
        off = max(int((t + gate) // period_s), on + 1)
        out.append(Note(int(rng.integers(0, NUM_CHANNELS)),
                        int(rng.integers(lo, hi + 1)),
                        int(rng.integers(vlo, vhi + 1)), on, off))
    return out
