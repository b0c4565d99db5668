"""Block meters on tensors (device half of libzl_tpu/ops/meters.py)."""

from __future__ import annotations

import torch


def block_peaks(audio):
    """Per-stream absolute peak. audio: [..., B, 2] -> [..., 2] f32."""
    return torch.amax(torch.abs(audio), dim=-2)


def block_rms(audio):
    """Per-stream RMS. audio: [..., B, 2] -> [..., 2] f32."""
    return torch.sqrt(torch.mean(torch.square(audio), dim=-2))
