"""The plain reference's clip render: a clip's playback buffer made again
from its source audio at a speed and a pitch, in NumPy alone. It imports
nothing of the program.

The upstream re-renders a clip offline when its speed or pitch changes
(`ClipAudioSource::updateTempoAndPitch`, lib/ClipAudioSource.cpp:384-402)
with tracktion's SoundTouch time-stretcher (CMakeLists.txt:86), a WSOLA
(waveform-similarity overlap-add). The program renders the same way
(`render_playback`: speed, then pitch, then gain) with a WSOLA of its own
in C++; this file restates that algorithm step for step, so that a buffer
rendered here is the program's bit for bit:

- the window from the rate: a sequence of 40 ms, an overlap of 8 ms and a
  seek of +-15 ms, each rounded half away from zero (at least 8, 4 overlaps
  and one overlap);
- the output length n_in * stretch rounded half to even (at least 1);
- an input shorter than one sequence and two seeks, or a stretch of
  exactly 1 (the program's stretch then returns its input: the same
  frames), repeats or drops whole frames (frame i reads frame
  trunc(i / stretch));
- otherwise the first sequence is copied, then each step finds, around
  the nominal input position (rounded half away from zero and clamped to
  [seek, n_in - seq - seek]), the offset whose overlap correlates best with
  the output's tail, on a float32 mono downmix (the channels summed in
  order from 0, times 1 / channels): a scan at stride 16 over [-seek,
  seek], then every offset within 15 of its winner not scanned yet. The
  correlation is sum(tail * candidate) / sqrt(sum(candidate^2)), float32
  products taken in float64 (where they are exact) and summed in order
  (the order of `np.cumsum` and of the C loop), -1e30 where the candidate's sum
  of squares is under 1e-12; a candidate wins only above the best so far,
  so the first of equal ones wins, and a scan where none passes -1e30 keeps
  offset 0;
- the overlap is crossfaded in float32, out * (1 - w) + in * w with w = k *
  (1 / overlap), then the sequence's body is copied, cut at the target
  length; the output moves on a sequence less an overlap a step and the
  input position on that over the stretch, summed in float64;
- pitch: a linear resample by 2^(p / 12) (the frame i * ratio, truncated,
  and the next, mixed in float32), stretched back by the input's length
  over the resampled one, then cut or zero-padded to the input's length;
- gain: times 10^(dB / 20) in float32.

Departures, none of which a clip's render reaches: an empty input (the
program returns one silent frame) raises here, the input is [T, C] (the
program takes [T] too), and the program's other stretch backends (the
phase vocoders) are not restated.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32
FLOOR = -1e30
STRIDE = 16
REFINE = 15


def _round_half_away(x: float) -> int:
    """C's lround / llround of a non-negative double."""
    f = math.floor(x)
    return int(f) + (1 if x - f >= 0.5 else 0)


def wsola_params(sample_rate: int) -> tuple:
    """(sequence, overlap, seek) in frames at `sample_rate`."""
    seq = _round_half_away(0.040 * sample_rate)
    overlap = _round_half_away(0.008 * sample_rate)
    seek = _round_half_away(0.015 * sample_rate)
    overlap = max(overlap, 8)
    seq = max(seq, 4 * overlap)
    seek = max(seek, overlap)
    return seq, overlap, seek


def out_len(n_in: int, stretch: float) -> int:
    return max(round(n_in * stretch), 1)


def _downmix(x: np.ndarray) -> np.ndarray:
    """float32 [n, C] -> float32 [n]: the channels summed in order from 0,
    times 1 / C."""
    acc = np.zeros(x.shape[0], F32)
    for c in range(x.shape[1]):
        acc = acc + x[:, c]
    return acc * (F32(1.0) / F32(x.shape[1]))


def _correlations(ref: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """Each candidate row's normalised correlation with `ref` (float64).
    The candidates lie in the columns of a C-contiguous [overlap, k] array,
    so each sum is a reduction over the slow axis, which NumPy takes row
    after row, in the order of `np.cumsum` (its pairwise summation works
    along the fast axis only) and seven times as fast."""
    c = np.ascontiguousarray(cands.T, dtype=np.float64)
    dot = np.add.reduce(c * ref.astype(np.float64)[:, None], axis=0)
    norm = np.add.reduce(c * c, axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = dot / np.sqrt(norm)
    return np.where(norm < 1e-12, FLOOR, out)


def _best_offset(windows: np.ndarray, base: int, seek: int,
                 ref: np.ndarray) -> int:
    """The offset around `base` whose overlap window (`windows`, the mono
    downmix's sliding windows) correlates best with `ref`."""
    coarse = np.arange(-seek, seek + 1, STRIDE)
    c = _correlations(ref, windows[base + coarse])
    i = int(np.argmax(c))
    best, best_c = 0, FLOOR
    if c[i] > best_c:
        best, best_c = int(coarse[i]), float(c[i])
    fine = np.arange(max(best - REFINE, -seek), min(best + REFINE, seek) + 1)
    fine = fine[(fine + seek) % STRIDE != 0]
    c = _correlations(ref, windows[base + fine])
    j = int(np.argmax(c))
    if c[j] > best_c:
        best = int(fine[j])
    return best


def wsola(x: np.ndarray, stretch: float, sample_rate: int) -> np.ndarray:
    """The WSOLA time stretch of float32 [T, C] by `stretch` (output
    duration = input x stretch), pitch kept."""
    n_in = x.shape[0]
    if n_in == 0:
        raise ValueError("an empty input")
    target = out_len(n_in, stretch)
    seq, overlap, seek = wsola_params(sample_rate)
    if n_in < seq + 2 * seek + 2 or stretch == 1.0:
        src = (np.arange(target, dtype=np.float64) / stretch).astype(
            np.int64)
        return x[np.minimum(src, n_in - 1)]
    mono = _downmix(x)
    windows = np.lib.stride_tricks.sliding_window_view(mono, overlap)
    hop_out = seq - overlap
    hop_in = hop_out / stretch
    out = np.zeros((target, x.shape[1]), F32)
    copy0 = min(seq, n_in, target)
    out[:copy0] = x[:copy0]
    out_pos = max(copy0 - overlap, 0)
    in_pos = hop_in
    inv_ov = F32(1.0) / F32(overlap)
    while out_pos + overlap < target:
        base = _round_half_away(in_pos)
        base = min(max(base, seek), n_in - seq - seek)
        ref = _downmix(out[out_pos:out_pos + overlap])
        src = x[base + _best_offset(windows, base, seek, ref):]
        k = min(overlap, target - out_pos)
        w = (np.arange(k, dtype=F32) * inv_ov)[:, None]
        dst = out[out_pos:out_pos + k]
        out[out_pos:out_pos + k] = dst * (F32(1.0) - w) + src[:k] * w
        body = seq - overlap
        if out_pos + seq > target:
            body = target - out_pos - overlap
        if body > 0:
            at = out_pos + overlap
            out[at:at + body] = src[overlap:overlap + body]
        out_pos += hop_out
        in_pos += hop_in
    return out


def linear_resample(samples: np.ndarray, ratio: float) -> np.ndarray:
    """Resample float32 [T, C] by `ratio` (over 1: shorter, higher),
    linearly interpolated in float32."""
    n_in = samples.shape[0]
    n_out = max(round(n_in / ratio), 1)
    pos = np.arange(n_out, dtype=np.float64) * ratio
    idx = np.minimum(pos.astype(np.int64), n_in - 1)
    nxt = np.minimum(idx + 1, n_in - 1)
    frac = (pos - idx).astype(F32)[:, None]
    return samples[idx] * (F32(1.0) - frac) + samples[nxt] * frac


def pitch_shift(samples: np.ndarray, semitones: float,
                sample_rate: int) -> np.ndarray:
    """Pitch by `semitones`, the length kept: resample, stretch back, then
    cut or zero-pad to the input's length."""
    if semitones == 0.0:
        return samples
    shifted = linear_resample(samples, 2.0 ** (semitones / 12.0))
    out = wsola(shifted, samples.shape[0] / shifted.shape[0], sample_rate)
    target = samples.shape[0]
    if out.shape[0] < target:
        out = np.concatenate(
            [out, np.zeros((target - out.shape[0], out.shape[1]), F32)])
    return out[:target]


def render_playback(samples: np.ndarray, speed_ratio: float = 1.0,
                    pitch_semitones: float = 0.0, gain_db: float = 0.0,
                    sample_rate: int = 48000) -> np.ndarray:
    """A clip's playback buffer from its source audio (float32 [T, C]):
    speed (a stretch by 1 / speed, the pitch kept), then pitch (the length
    kept), then gain."""
    out = np.asarray(samples, F32)
    if speed_ratio not in (0.0, 1.0):
        out = wsola(out, 1.0 / speed_ratio, sample_rate)
    if pitch_semitones != 0.0:
        out = pitch_shift(out, pitch_semitones, sample_rate)
    if gain_db != 0.0:
        out = out * F32(10.0 ** (gain_db / 20.0))
    return np.ascontiguousarray(out, F32)
