"""Channel strips: the numpy host half and the torch device half.

The counterpart of libzl_tpu/ops/mixer.py (the JackPassthrough equivalent:
11 passthrough strips, each splitting a stereo input into dry / wetFx1 /
wetFx2 pairs with per-strip amount, linear pan and mute,
lib/JackPassthrough.cpp:45-115). `StripParams` and `default_strip_params`
are the reference's host code, copied verbatim; `apply_strips` runs on
tensors.

Linear pan law (lib/JackPassthrough.cpp:100-110):
    out_l = amount * in_l * min(1 - pan, 1)
    out_r = amount * in_r * min(1 + pan, 1)
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class StripParams(NamedTuple):
    """Parameters for K strips; arrays [K] f32 (muted as 0/1 f32)."""

    dry: Any
    wet1: Any
    wet2: Any
    pan: Any
    muted: Any


def default_strip_params(num_strips: int) -> StripParams:
    """Reference defaults: dry=1, wets=1, pan=0, unmuted
    (lib/JackPassthrough.cpp:24-28); the GlobalPlayback strip's wets are
    zeroed at creation by MidiRouter (lib/MidiRouter.cpp:876-880) — the host
    engine applies that policy, not this constructor."""
    ones = np.ones(num_strips, np.float32)
    zeros = np.zeros(num_strips, np.float32)
    return StripParams(dry=ones.copy(), wet1=ones.copy(), wet2=ones.copy(),
                       pan=zeros.copy(), muted=zeros.copy())


def apply_strips(audio, params: StripParams):
    """Apply K strips to K stereo streams, in the reference's f32 order.

    audio: [K, B, 2] f32; params fields [K] f32 tensors. Returns (dry, wet1,
    wet2), each [K, B, 2]."""
    pan = params.pan[:, None]
    gate = (1.0 - params.muted)[:, None]  # 0 when muted
    l_scale = torch.clamp_max(1.0 - pan, 1.0) * gate
    r_scale = torch.clamp_max(1.0 + pan, 1.0) * gate
    scale = torch.stack([l_scale, r_scale], dim=-1)  # [K, 1, 2]
    scaled = audio * scale

    def send(amount):
        return scaled * amount[:, None, None]

    return send(params.dry), send(params.wet1), send(params.wet2)
