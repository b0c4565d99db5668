"""Offline time-stretch / pitch-shift rendering (the tracktion render pass).

The reference delegates stretch and pitch to tracktion's TimeStretcher
(SoundTouch backend, CMakeLists.txt:86) which renders an offline "playback
file" that the sampler then plays at unity rate
(lib/ClipAudioSource.cpp:384-402 updateTempoAndPitch;
lib/SamplerSynthSound.cpp:29-47 loads the *playback* file, not the source).
Only the per-note +/-semitone varispeed happens live in the voice kernel.

This module reproduces that design: `render_playback` produces the processed
sample buffer uploaded to the sound bank whenever speedRatio / pitchChange /
gain change. The stretcher is a standard STFT phase vocoder with identity
phase locking; pitch shift = resample + stretch back. Semantics:

- speed_ratio r: playback speed multiplier WITHOUT pitch change
  (output duration = input / r)
- pitch_semitones p: pitch shift WITHOUT duration change
- gain_db: clip gain baked into the render (tracktion clip->setGainDB,
  lib/ClipAudioSource.cpp:305-310)

Runs in numpy on the host: renders are rare (parameter changes), happen off
the audio path, and the result is device-uploaded once. A jax.signal STFT
variant can replace the core later without changing callers.

A copy of libzl_tpu/ops/resample.py, verbatim apart from this note and the
'jax' stretch backend: the accelerator-resident vocoder is not ported yet
(ROADMAP Queue 1 item 1, the torch stretch), so asking for it raises
NotImplementedError instead of falling back. The port keeps its own copy so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def linear_resample(samples: np.ndarray, ratio: float) -> np.ndarray:
    """Resample [T, C] by `ratio` (>1 = faster/shorter), linear interpolation.

    This is the varispeed primitive: pitch and speed change together.
    """
    if ratio == 1.0:
        return samples.astype(np.float32, copy=False)
    if samples.ndim == 1:
        # 1-D input would broadcast against frac[:, None] into an
        # [n_out, n_out] matrix — normalize to [T, 1] and squeeze back
        return linear_resample(samples[:, None], ratio)[:, 0]
    n_in = samples.shape[0]
    n_out = max(int(round(n_in / ratio)), 1)
    pos = np.arange(n_out, dtype=np.float64) * ratio
    idx = np.minimum(pos.astype(np.int64), n_in - 1)
    nxt = np.minimum(idx + 1, n_in - 1)
    frac = (pos - idx).astype(np.float32)[:, None]
    out = samples[idx] * (1.0 - frac) + samples[nxt] * frac
    return out.astype(np.float32)


try:  # scipy.fft does float32 rfft natively (~40x numpy's f64-only path)
    from scipy import fft as _fft
except ImportError:  # pragma: no cover
    _fft = np.fft

# frames per vectorized chunk: bounds peak memory to ~chunk * fft_size
# complex64 temporaries (~16 MB/array at 2048-point FFT) independent of
# input length
_STRETCH_CHUNK_FRAMES = 2048


def time_stretch(
    samples: np.ndarray, stretch: float, fft_size: int = 2048, hop: int = 512
) -> np.ndarray:
    """Phase-vocoder time stretch of [T, C] by factor `stretch` (output
    duration = input * stretch), pitch preserved.

    Fully vectorized: strided-window STFT (one batched rfft per chunk of
    frames), phase advance re-accumulated at the synthesis hop via a
    segmented cumulative sum, reshape-based overlap-add. Transients are
    preserved by phase reset: frames whose positive spectral flux spikes
    (an onset) restart phase accumulation from the analysis phase, so a
    click train stays a click train instead of smearing — the quality trait
    the reference gets from SoundTouch (CMakeLists.txt:86).
    """
    if stretch == 1.0:
        return samples.astype(np.float32, copy=False)
    samples = np.atleast_2d(samples.T).T
    n_in, n_ch = samples.shape
    syn_hop = hop
    ana_hop = hop / stretch
    win = np.hanning(fft_size).astype(np.float32)
    n_bins = fft_size // 2 + 1
    omega = (2.0 * np.pi * np.arange(n_bins) / fft_size).astype(np.float32)

    # frames must COVER the target output length (round(n_in*stretch)):
    # computing them from the input span alone left ~fft*(stretch-1)
    # samples of hard zero-padding at the stretched tail (an audible early
    # cutoff on one-shots). Extra frames clamp to the final analysis
    # window via `anchors`, sustaining the ending instead.
    target_len = max(int(round(n_in * stretch)), 1)
    M = max(
        int((n_in - fft_size) / ana_hop),
        int(np.ceil((target_len - fft_size) / syn_hop)) + 1,
        1,
    )
    x = samples.astype(np.float32)
    if n_in < fft_size:
        x = np.pad(x, ((0, fft_size - n_in), (0, 0)))
    anchors = np.minimum(
        np.round(np.arange(M) * ana_hop).astype(np.int64),
        max(n_in - fft_size, 0),
    )
    # row-gather of analysis windows: a strided view indexed by frame anchor
    # (one index per frame) — ~15x cheaper than an element-wise fancy index
    # of the same [m, fft] matrix. Layout [m, C, K] keeps the FFT axis
    # contiguous.
    windows = np.lib.stride_tricks.sliding_window_view(
        x, fft_size, axis=0
    )  # [T-K+1, C, K] view

    out_len = (M - 1) * syn_hop + fft_size
    out = np.zeros((out_len, n_ch), np.float32)
    norm = np.zeros(out_len, np.float32)
    w2 = (win * win).astype(np.float32)

    # Phase bookkeeping in strict float32 (python-float scalars upcast whole
    # [m, bins, C] arrays to f64 — measured ~4x slowdown). The accumulated
    # phase splits into a linear part omega*syn_hop*i (exactly periodic in i
    # with period fft/hop when hop | fft — a tiny wrapped table) plus an f32
    # cumsum of the bounded per-frame deviations (|dphi|*stretch <= pi*s).
    two_pi = np.float32(2.0 * np.pi)
    inv_two_pi = np.float32(1.0 / (2.0 * np.pi))
    stretch32 = np.float32(syn_hop / ana_hop)
    exp_ana = (omega * np.float32(ana_hop)).astype(np.float32)
    if fft_size % syn_hop == 0:
        R = fft_size // syn_hop
        lin_table = np.mod(
            np.arange(R)[:, None] * omega.astype(np.float64) * syn_hop,
            2.0 * np.pi,
        ).astype(np.float32)                                   # [R, Kb]

        def lin_for(counts):
            return lin_table[counts % R]
    else:
        def lin_for(counts):
            return np.mod(
                counts[:, None] * (omega.astype(np.float64) * syn_hop),
                2.0 * np.pi,
            ).astype(np.float32)

    # carried state across chunks: the previous frame's analysis phase and
    # accumulated (wrapped) synthesis phase, per (bin, channel)
    prev_phase = None
    prev_acc = None
    prev_mag_sum = np.zeros(n_ch, np.float32)
    for lo in range(0, M, _STRETCH_CHUNK_FRAMES):
        hi = min(lo + _STRETCH_CHUNK_FRAMES, M)
        frames = windows[anchors[lo:hi]].copy()                # [m, C, K]
        frames *= win[None, None, :]
        F = _fft.rfft(frames, axis=-1)                         # [m, C, Kb]
        # keep complex64 + contiguous: the transcendentals and the inverse
        # FFT below are ~50x slower on strided/upcast arrays
        F = np.ascontiguousarray(F, dtype=np.complex64)
        mag = np.abs(F)
        phase = np.angle(F)
        m = hi - lo

        # wrapped per-frame phase deviation vs the expected bin advance,
        # scaled to the synthesis hop (first frame diffs against the carry)
        ddphi = np.empty((m, n_ch, n_bins), np.float32)
        if prev_phase is None:
            # frame 0 carries no advance: pre-load the expected bin advance
            # so the unconditional subtraction below zeroes it exactly — a
            # 0.0 here would inject a wrapped(-omega*ana_hop) rotation into
            # every bin's accumulated phase and comb-cancel the mix
            ddphi[0] = exp_ana[None, :]
            np.subtract(phase[1:], phase[:-1], out=ddphi[1:])
            counts = np.arange(m)
        else:
            np.subtract(phase[0], prev_phase, out=ddphi[0])
            np.subtract(phase[1:], phase[:-1], out=ddphi[1:])
            counts = np.arange(1, m + 1)    # advances relative to carry
        ddphi -= exp_ana[None, None, :]
        ddphi -= two_pi * np.round(ddphi * inv_two_pi)
        ddphi *= stretch32
        c = np.cumsum(ddphi, axis=0)                           # f32 [m,C,Kb]
        c += lin_for(counts)[:, None, :]
        base_acc = phase[0] if prev_acc is None else prev_acc

        # onset detection: positive spectral flux per frame/channel, with
        # the carry-in magnitude sum for the chunk's first frame
        mag_sum = mag.sum(axis=2)                              # [m, C]
        prev_sums = np.concatenate([prev_mag_sum[None], mag_sum[:-1]], axis=0)
        flux = np.maximum(mag_sum - prev_sums, 0.0)
        thresh = flux.mean(axis=0) + 2.0 * flux.std(axis=0)
        onset = flux > np.maximum(thresh, np.float32(1e-6))[None, :]  # [m, C]
        if prev_phase is None:
            onset[0, :] = False  # frame 0 already starts at analysis phase

        # segmented accumulation: default acc = base + c; at an onset frame
        # o the phase restarts from the analysis phase, so for frames in
        # o's segment acc = phase[o] - c[o] + c. One gather does both: row 0
        # of `bases` is the carried base (whose c-offset is 0 by
        # construction), rows 1.. are per-frame (phase - c).
        if onset.any():
            midx = np.arange(m)[:, None]
            seg = np.maximum.accumulate(np.where(onset, midx, -1), axis=0)
            bases = np.empty((m + 1, n_ch, n_bins), np.float32)
            bases[0] = base_acc
            np.subtract(phase, c, out=bases[1:])
            acc = np.take_along_axis(bases, (seg + 1)[:, :, None], axis=0)
            acc += c
        else:
            acc = c
            acc += base_acc[None]

        # build the rotated spectrum without np.exp(1j*...), which upcasts
        # to complex128 (measured ~80x slower than f32 cos/sin)
        Z = np.empty(acc.shape, np.complex64)
        np.multiply(mag, np.cos(acc), out=Z.real)
        np.multiply(mag, np.sin(acc), out=Z.imag)
        y = _fft.irfft(Z, n=fft_size, axis=-1)
        y = np.ascontiguousarray(y, dtype=np.float32)
        y *= win[None, None, :]                                # [m, C, K]

        # overlap-add at the synthesis hop (vectorized: one strided add per
        # window/hop overlap factor)
        pos0 = lo * syn_hop
        if fft_size % syn_hop == 0:
            R = fft_size // syn_hop
            for j in range(R):
                s = pos0 + j * syn_hop
                seg_len = m * syn_hop
                blk = y[:, :, j * syn_hop : (j + 1) * syn_hop]
                out[s : s + seg_len] += blk.transpose(0, 2, 1).reshape(
                    seg_len, n_ch
                )
                norm[s : s + seg_len] += np.tile(
                    w2[j * syn_hop : (j + 1) * syn_hop], m
                )
        else:  # non-divisible hop: scatter-add fallback
            idx = (
                pos0
                + np.arange(m)[:, None] * syn_hop
                + np.arange(fft_size)[None, :]
            ).ravel()
            for ch in range(n_ch):
                np.add.at(out[:, ch], idx, y[:, ch, :].ravel())
            np.add.at(norm, idx, np.tile(w2, m))

        prev_phase = phase[-1]
        # wrap the carried phase so f32 precision never degrades with length
        a = acc[-1]
        prev_acc = a - two_pi * np.round(a * inv_two_pi)
        prev_mag_sum = mag_sum[-1]

    # normalize by the window overlap; where coverage collapses (the
    # first/last partial frames) output silence instead of amplifying
    # rounding noise by 1/norm
    floor = 0.05 * max(float(norm.max()), 1e-8)
    scale = np.where(norm > floor, 1.0 / np.maximum(norm, floor), 0.0)
    result = out * scale[:, None]
    target = max(int(round(n_in * stretch)), 1)
    if result.shape[0] < target:
        result = np.pad(result, ((0, target - result.shape[0]), (0, 0)))
    return result[:target].astype(np.float32)


def resolve_stretch_backend(backend: str = "auto") -> str:
    """Resolve the stretch backend: 'wsola' (native/zl_stretch.cpp, the
    reference's SoundTouch-class algorithm), 'vocoder' (the numpy phase
    vocoder above) or 'jax' (the accelerator-resident vocoder,
    ops/stretch_jax.py — deferred re-renders stop contending with the
    block pump for the host core). An explicit `backend` wins;
    LIBZL_TPU_STRETCH overrides only the 'auto' default, which picks the
    native WSOLA when the library builds, else the vocoder. Requesting
    'wsola' explicitly on a host where it cannot build raises instead of
    silently substituting."""
    import os

    from . import stretch_native

    choice = (backend or "auto").lower()
    if choice == "auto":
        choice = os.environ.get("LIBZL_TPU_STRETCH", "auto").lower()
    if choice in ("wsola", "native"):
        if not stretch_native.available():
            raise ValueError(
                "stretch backend 'wsola' requested but the native "
                "stretcher is unavailable (no compiler?); use 'auto' or "
                "'vocoder'"
            )
        return "wsola"
    if choice in ("vocoder", "pv", "python"):
        return "vocoder"
    if choice == "jax":
        raise NotImplementedError(
            "stretch backend 'jax' (the accelerator-resident vocoder) is not "
            "ported to libzl_tpu_torch yet: ROADMAP Queue 1 item 1, the "
            "torch stretch; use 'auto', 'wsola' or 'vocoder'"
        )
    if choice != "auto":
        # a typo'd explicit request must fail loudly, not silently run the
        # auto default (A/B probes would measure the wrong stretcher)
        raise ValueError(
            f"unknown stretch backend {choice!r}: use 'auto', 'wsola', "
            f"'vocoder' or 'jax'"
        )
    return "wsola" if stretch_native.available() else "vocoder"


def stretch(
    samples: np.ndarray,
    factor: float,
    sample_rate: int = 48000,
    backend: str = "auto",
) -> np.ndarray:
    """Time stretch [T, C] by `factor` (output duration = input * factor),
    pitch preserved, via the resolved backend."""
    if factor == 1.0:
        return np.asarray(samples, np.float32)
    resolved = resolve_stretch_backend(backend)
    if resolved == "wsola":
        from . import stretch_native

        return stretch_native.time_stretch_wsola(samples, factor, sample_rate)
    return time_stretch(samples, factor)


def pitch_shift(
    samples: np.ndarray, semitones: float, fft_size: int = 2048,
    hop: int = 512, sample_rate: int = 48000, backend: str = "vocoder"
) -> np.ndarray:
    """Pitch shift [T, C] by `semitones`, duration preserved."""
    if semitones == 0.0:
        return samples.astype(np.float32, copy=False)
    ratio = 2.0 ** (semitones / 12.0)
    # resample (shifts pitch by ratio, shortens by ratio), then stretch back
    shifted = linear_resample(samples, ratio)
    out = stretch(shifted, samples.shape[0] / shifted.shape[0],
                  sample_rate, backend) if backend != "vocoder" else \
        time_stretch(shifted, samples.shape[0] / shifted.shape[0],
                     fft_size, hop)
    target = samples.shape[0]
    if out.shape[0] < target:
        out = np.pad(out, ((0, target - out.shape[0]), (0, 0)))
    return out[:target].astype(np.float32)


def bake_loop_crossfade(
    samples: np.ndarray,
    loop_start: int,
    loop_stop: int,
    fade_samples: int,
) -> np.ndarray:
    """Bake an equal-power loop crossfade into a playback buffer.

    The reference loops with a hard position reset
    (lib/SamplerSynthVoice.cpp:241-246), which clicks on non-zero-crossing
    material. Consistent with the render-then-play design, the crossfade is
    baked offline: the tail of the loop region is blended with the material
    *preceding* the loop start, so the voice kernel's plain reset lands on
    already-continuous audio. The fade is shortened when not enough
    pre-start material exists.
    """
    out = np.array(samples, np.float32, copy=True)
    n = int(min(fade_samples, loop_start, max(loop_stop - loop_start, 0)))
    if n <= 0:
        return out
    t = (np.arange(n, dtype=np.float32) + 1.0) / np.float32(n)
    # equal-power: tail fades out as cos, incoming pre-start fades in as sin
    fade_out = np.cos(0.5 * np.pi * t)[:, None]
    fade_in = np.sin(0.5 * np.pi * t)[:, None]
    tail = out[loop_stop - n : loop_stop]
    incoming = out[loop_start - n : loop_start]
    out[loop_stop - n : loop_stop] = tail * fade_out + incoming * fade_in
    return out


def render_playback(
    samples: np.ndarray,
    speed_ratio: float = 1.0,
    pitch_semitones: float = 0.0,
    gain_db: float = 0.0,
    sample_rate: int = 48000,
    backend: str = "auto",
) -> np.ndarray:
    """Full offline render: stretch + pitch + gain -> playback buffer.

    `backend` selects the stretcher (resolve_stretch_backend): the native
    WSOLA matches the reference's SoundTouch time-domain design
    (CMakeLists.txt:86) and is ~an order of magnitude faster than the
    numpy phase vocoder; both preserve durations and pitch.
    """
    out = np.asarray(samples, np.float32)
    if speed_ratio not in (0.0, 1.0):
        out = stretch(out, 1.0 / speed_ratio, sample_rate, backend)
    if pitch_semitones != 0.0:
        out = pitch_shift(out, pitch_semitones, sample_rate=sample_rate,
                          backend=backend)
    if gain_db != 0.0:
        out = (out * np.float32(10.0 ** (gain_db / 20.0))).astype(np.float32)
    return out
