"""Block meters: the host dBFS helpers and the torch reductions.

The counterpart of libzl_tpu/ops/meters.py. `to_dbfs` and `add_dbfs` are
the reference's host code, copied verbatim (models/audio_levels.py applies
them at its own cadence); the per-block peak and RMS reductions run on
tensors.
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


def to_dbfs(raw: float) -> float:
    """convertTodbFS semantics (lib/AudioLevels.cpp:330-341): 20*log10 with a
    -200 dB floor, and non-positive input mapping to the floor."""
    if raw <= 0:
        return METER_DBFS_FLOOR
    v = 20.0 * np.log10(raw)
    return float(max(v, METER_DBFS_FLOOR))


def add_dbfs(db1: float, db2: float) -> float:
    """Power-sum of two dBFS values (lib/AudioLevels.cpp:234-236,343-345)."""
    return float(10.0 * np.log10(10.0 ** (db1 / 10.0) + 10.0 ** (db2 / 10.0)))
