"""Channel strips on tensors (device half of libzl_tpu/ops/mixer.py).

Linear pan law (lib/JackPassthrough.cpp:100-110):
    out_l = amount * in_l * min(1 - pan, 1)
    out_r = amount * in_r * min(1 + pan, 1)
`StripParams` and `default_strip_params` are host-side and stay in the
reference.
"""

from __future__ import annotations

import torch

from libzl_tpu.ops.mixer import StripParams


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
