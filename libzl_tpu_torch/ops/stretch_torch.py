"""The accelerator phase-vocoder time stretch on torch.fft
(`LIBZL_TPU_STRETCH=torch`, or `jax`, the reference's spelling).

A port of libzl_tpu/ops/stretch_jax.py: the same algorithm as the numpy
vocoder (ops/resample.time_stretch) run as one batch on the device, so a
clip's deferred re-render costs the host a dispatch instead of a whole-clip
STFT. The reference's vocoder is plain `jnp` lowered by XLA, not a Pallas
kernel, so the port is plain PyTorch:

- strided analysis windows gathered by frame anchor (the anchors computed on
  the host in float64, exactly the numpy path's `round(arange(M) * ana_hop)`);
- `rfft`, magnitude and phase; the wrapped per-frame phase deviation, with
  frame 0 preloaded with the expected advance so it carries none;
- the linear phase `counts * omega * hop` wrapped on the host in float64 and
  cast to float32 (float64 on the device would move the numbers);
- positive spectral-flux onsets over global statistics, and phase restarts
  at each onset (`torch.cummax` in place of `associative_scan`);
- `irfft`, the synthesis window, and the overlap-add; the window-power
  envelope, its floor, the division and the trim on the host.

Two departures, neither of which changes the output:

- the reference pads the input to a power-of-two length and the frame count
  to a 128-frame bucket (with a validity mask) so XLA reuses one compiled
  program per bucket; PyTorch compiles nothing, so the port renders exactly
  the M real frames, and the padded frames it drops were masked to zero;
- where `fft_size % hop != 0` the reference scatter-adds every window sample
  (XLA's scatter; `index_add_` on the card uses atomics, so its float sums
  would change from run to run). The port pads each window with zeros to
  R = ceil(fft_size / hop) hops and runs the reshape overlap-add's loop over
  the R phases: the same sums, in a fixed order, with the same bits on every
  run. Where `hop` divides `fft_size` the padding is empty and this is the
  reference's reshape path.

A bin of exactly zero magnitude gets phase 0 here. `atan2` of a signed zero
is ±0 or ±π, and which one depends on the FFT library's zero signs, so the
card and the CPU would part ways after a silent frame; the reference leaves
it to its FFT backend.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device


def _frame_anchors(n_in: int, stretch: float, fft_size: int, hop: int):
    """(M, anchors int64 [M], target_len): ops/resample.time_stretch's frame
    count and analysis anchors."""
    ana_hop = hop / stretch
    target_len = max(int(round(n_in * stretch)), 1)
    M = max(
        int((n_in - fft_size) / ana_hop),
        int(np.ceil((target_len - fft_size) / hop)) + 1,
        1,
    )
    anchors = np.minimum(
        np.round(np.arange(M) * ana_hop).astype(np.int64),
        max(n_in - fft_size, 0),
    )
    return M, anchors, target_len


def _linear_phase(M: int, fft_size: int, hop: int) -> np.ndarray:
    """[M, fft/2+1] f32: frame m's linear synthesis phase m * omega * hop,
    wrapped to [0, 2π) in float64 on the host (periodic in m with period
    fft/hop where hop divides fft: a table of that many rows)."""
    n_bins = fft_size // 2 + 1
    step = 2.0 * np.pi * np.arange(n_bins) / fft_size * hop
    if fft_size % hop == 0:
        R = fft_size // hop
        table = np.mod(np.arange(R)[:, None] * step, 2.0 * np.pi)
        return table.astype(np.float32)[np.arange(M) % R]
    return np.mod(np.arange(M, dtype=np.float64)[:, None] * step,
                  2.0 * np.pi).astype(np.float32)


def _stretch_device(x, anchors, lin, exp_ana, stretch32: float,
                    fft_size: int, hop: int):
    """windows -> rfft -> phase vocoder -> irfft -> overlap-add on x's
    device. x [T, C] f32, anchors [M] int64, lin [M, Kb] f32, exp_ana [Kb]
    f32. Returns the un-normalised overlap-add [(M-1)*hop + fft_size, C]."""
    f32 = torch.float32
    dev = x.device
    M = anchors.shape[0]
    n_ch = x.shape[1]
    win = torch.from_numpy(np.hanning(fft_size).astype(np.float32)).to(dev)

    # strided analysis windows: [M, C, K] gathered by frame anchor
    idx = anchors[:, None] + torch.arange(fft_size, device=dev)[None, :]
    frames = x[idx].permute(0, 2, 1) * win
    F = torch.fft.rfft(frames, dim=-1)                   # [M, C, Kb] c64
    mag = F.abs()
    phase = torch.where(mag == 0, 0.0, F.angle())

    two_pi = np.float32(2.0 * np.pi)
    inv_two_pi = np.float32(1.0 / (2.0 * np.pi))
    ddphi = torch.cat([exp_ana.expand(1, n_ch, -1), phase[1:] - phase[:-1]])
    ddphi = ddphi - exp_ana
    ddphi = ddphi - two_pi * torch.round(ddphi * inv_two_pi)
    c = torch.cumsum(ddphi * stretch32, dim=0) + lin[:, None, :]

    # onsets: positive spectral flux against global statistics; frame 0
    # never resets (the carry-in magnitude sum for frame 0 is zero)
    mag_sum = mag.sum(dim=2)                             # [M, C]
    prev_sums = torch.cat([torch.zeros_like(mag_sum[:1]), mag_sum[:-1]])
    flux = torch.clamp_min(mag_sum - prev_sums, 0.0)
    mean = flux.sum(dim=0) / M
    var = ((flux - mean) ** 2).sum(dim=0) / M
    thresh = torch.clamp_min(mean + 2.0 * torch.sqrt(var), 1e-6)
    onset = flux > thresh
    onset[0] = False

    # phase restarts from the analysis phase at each onset frame: row 0 of
    # `bases` is phase[0] (c[0] is zero by the frame-0 preload), row m+1
    # frame m's phase - c
    midx = torch.arange(M, device=dev)[:, None]
    seg = torch.cummax(torch.where(onset, midx, -1), dim=0).values
    bases = torch.cat([phase[:1], phase - c])
    acc = torch.gather(bases, 0, (seg + 1)[:, :, None].expand(-1, -1,
                                                             c.shape[2])) + c

    Z = torch.complex(mag * torch.cos(acc), mag * torch.sin(acc))
    y = torch.fft.irfft(Z, n=fft_size, dim=-1).to(f32) * win   # [M, C, K]

    # overlap-add over the R phases of the synthesis hop: frames' j-th hop
    # chunks tile [j*hop, j*hop + M*hop) without overlap
    R = -(-fft_size // hop)
    y = torch.nn.functional.pad(y, (0, R * hop - fft_size))
    out = torch.zeros(((M + R - 1) * hop, n_ch), dtype=f32, device=dev)
    for j in range(R):
        blk = y[:, :, j * hop:(j + 1) * hop].permute(0, 2, 1)
        out[j * hop:j * hop + M * hop] += blk.reshape(M * hop, n_ch)
    return out[:(M - 1) * hop + fft_size]


def _window_power(M: int, fft_size: int, hop: int) -> np.ndarray:
    """The overlap-add of the squared window, [(M-1)*hop + fft_size] f32,
    summed in the device overlap-add's order."""
    w = np.hanning(fft_size).astype(np.float32)
    R = -(-fft_size // hop)
    w2 = np.zeros(R * hop, np.float32)
    w2[:fft_size] = w * w
    norm = np.zeros((M + R - 1) * hop, np.float32)
    for j in range(R):
        norm[j * hop:j * hop + M * hop] += np.tile(w2[j * hop:(j + 1) * hop],
                                                   M)
    return norm[:(M - 1) * hop + fft_size]


def time_stretch_torch(samples: np.ndarray, stretch: float,
                       fft_size: int = 2048, hop: int = 512,
                       device="cuda") -> np.ndarray:
    """Phase-vocoder time stretch of [T, C] (or [T]) by `stretch` on
    `device`, pitch preserved; returns numpy float32 [round(T * stretch), C].
    Duration semantics are ops/resample.time_stretch's. `device` is explicit
    ("cuda" without a card raises); the calling thread enters it, so a
    clip's render worker may call this."""
    if stretch == 1.0:
        return np.asarray(samples, np.float32)
    dev = resolve_device(device)
    samples = np.atleast_2d(np.asarray(samples, np.float32).T).T
    n_in = samples.shape[0]
    M, anchors, target_len = _frame_anchors(n_in, stretch, fft_size, hop)
    x = samples
    if n_in < fft_size:
        x = np.pad(x, ((0, fft_size - n_in), (0, 0)))
    n_bins = fft_size // 2 + 1
    exp_ana = (2.0 * np.pi * np.arange(n_bins) / fft_size
               * (hop / stretch)).astype(np.float32)
    ctx = (torch.cuda.device(dev) if dev.type == "cuda"
           else contextlib.nullcontext())
    with ctx, torch.no_grad():
        out = _stretch_device(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev),
            torch.from_numpy(anchors).to(dev),
            torch.from_numpy(_linear_phase(M, fft_size, hop)).to(dev),
            torch.from_numpy(exp_ana).to(dev),
            np.float32(hop / (hop / stretch)), fft_size, hop,
        ).cpu().numpy()
    # the numpy path's normalisation: silence where the window coverage
    # collapses instead of amplifying rounding noise
    norm = _window_power(M, fft_size, hop)
    floor = 0.05 * max(float(norm.max()), 1e-8)
    scale = np.where(norm > floor, 1.0 / np.maximum(norm, floor), 0.0)
    result = out * scale[:, None]
    if result.shape[0] < target_len:
        result = np.pad(result, ((0, target_len - result.shape[0]), (0, 0)))
    return result[:target_len].astype(np.float32)
