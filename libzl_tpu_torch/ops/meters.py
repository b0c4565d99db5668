"""Block meters: the host dBFS helpers and the torch reductions.

The counterpart of libzl_tpu/ops/meters.py. `to_dbfs` and `add_dbfs` give
the reference's host values for a whole array at once
(models/audio_levels.py applies them at its own cadence); the per-block
peak and RMS reductions run on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import METER_DBFS_FLOOR


def block_peaks(audio):
    """Per-stream absolute peak. audio: [..., B, 2] -> [..., 2] f32."""
    return torch.amax(torch.abs(audio), dim=-2)


def block_rms(audio):
    """Per-stream RMS. audio: [..., B, 2] -> [..., 2] f32."""
    return torch.sqrt(torch.mean(torch.square(audio), dim=-2))


def to_dbfs(raw) -> np.ndarray:
    """convertTodbFS (lib/AudioLevels.cpp:330-341) of each value: 20*log10
    with a -200 dB floor, non-positive input at the floor; float64,
    bit-equal to the reference's value-by-value form (numpy's log10 takes
    the same path for an array as for a scalar)."""
    raw = np.asarray(raw, np.float64)
    out = np.full(raw.shape, METER_DBFS_FLOOR)
    live = ~(raw <= 0)
    np.log10(raw, out=out, where=live)
    np.multiply(out, 20.0, out=out, where=live)
    return np.maximum(out, METER_DBFS_FLOOR, out=out)


def add_dbfs(db1, db2) -> np.ndarray:
    """Power-sum of each pair of dBFS values (lib/AudioLevels.cpp:234-236,
    343-345), bit-equal to the reference's value-by-value form. The powers
    are Python's, libm's pow as numpy's scalar power is: numpy's array
    power (SIMD on AVX-512 builds) can round differently in the last
    place."""
    q1 = (np.asarray(db1, np.float64) / 10.0).tolist()
    q2 = (np.asarray(db2, np.float64) / 10.0).tolist()
    return 10.0 * np.log10(
        np.array([10.0 ** a + 10.0 ** b for a, b in zip(q1, q2)]))
