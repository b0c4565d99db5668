"""Waveform thumbnails in PyTorch: batched min/max envelopes.

The port of libzl_tpu/ops/thumbnail.py (lib/WaveFormItem.cpp:21-22: 512
buckets per thumbnail). A thumbnail is the per-bucket (min, max) envelope of
the samples: a reshape and two reductions, for any number of sounds at once
(`thumbnail_batch`, the counterpart of `thumbnail_jit`). The reference
module jits at import, so the port cannot import it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

DEFAULT_THUMB_SIZE = 512  # lib/WaveFormItem.cpp:21


def thumbnail_math(samples: torch.Tensor, num_buckets: int):
    """Min/max envelope of [T, C] (or [N, T, C], or mono [T]) samples.

    Returns (mins, maxs) shaped [..., num_buckets, C]. The tail that does
    not fill a whole bucket is dropped; an empty window is a flat zero
    envelope; a window shorter than the bucket count is edge-padded so
    every bucket exists."""
    if samples.ndim == 1:
        samples = samples[:, None]  # mono 1-D -> [T, 1]
    t_axis = samples.ndim - 2
    T = samples.shape[t_axis]
    if T == 0:
        shape = list(samples.shape)
        shape[t_axis] = num_buckets
        z = torch.zeros(shape, dtype=torch.float32, device=samples.device)
        return z, z
    bucket = max(T // num_buckets, 1)
    usable = bucket * num_buckets
    if T < usable:
        last = samples.narrow(t_axis, T - 1, 1)
        reps = [1] * samples.ndim
        reps[t_axis] = usable - T
        samples = torch.cat([samples, last.repeat(reps)], dim=t_axis)
    trimmed = samples.narrow(t_axis, 0, usable)
    trimmed = trimmed.reshape(*samples.shape[:t_axis], num_buckets, bucket,
                              samples.shape[-1])
    return trimmed.amin(dim=t_axis + 1), trimmed.amax(dim=t_axis + 1)


def thumbnail_batch(samples, num_buckets: int = DEFAULT_THUMB_SIZE,
                    device=None):
    """Thumbnails of a batch of sounds [N, T, C] in one reduction. A tensor
    is reduced on its device unless `device` is given; an array is moved to
    `device` (default "cuda": without a card that raises) first. Returns
    (mins, maxs) [N, num_buckets, C] on that device."""
    if not torch.is_tensor(samples):
        samples = torch.from_numpy(np.ascontiguousarray(samples, np.float32))
        if device is None:
            device = "cuda"
    if device is not None:
        samples = samples.to(resolve_device(device))
    return thumbnail_math(samples, num_buckets)


def thumbnail_region(
    samples: np.ndarray,
    start_seconds: float,
    end_seconds: float,
    sample_rate: float,
    num_buckets: int = DEFAULT_THUMB_SIZE,
    device="cuda",
):
    """Thumbnail of a zoom window (WaveFormItem start/end properties,
    lib/WaveFormItem.cpp:78-108), reduced on `device` (default "cuda":
    without a card that raises); numpy (mins, maxs) [num_buckets, C]."""
    device = resolve_device(device)
    T = samples.shape[0]
    s = max(int(start_seconds * sample_rate), 0)
    e = min(int(end_seconds * sample_rate), T)
    if e <= s:
        # samples.shape[-1] is the FRAME count for 1-D mono input — the
        # channel count must come from the normalized-to-2D view
        n_ch = 1 if samples.ndim == 1 else samples.shape[-1]
        z = np.zeros((num_buckets, n_ch), np.float32)
        return z, z
    mins, maxs = thumbnail_batch(samples[s:e], num_buckets, device)
    return mins.cpu().numpy(), maxs.cpu().numpy()
