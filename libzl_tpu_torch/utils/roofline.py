"""The least time the card could take for one call of each hand-written
kernel: the bytes its own inputs and output need at the H100's memory rate
against its float32 work at the card's peak (NVIDIA's data sheet, SXM part).
`chip_smoke.py` and `libzl_tpu_torch.bench` print each kernel's measured
time beside these bounds."""

from __future__ import annotations

import torch

from ..ops.fetch_windows import region_rows

HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def fetch_bound(args, r_max: float = 4.0) -> dict:
    """The least time the card could take for one windows fetch on these
    inputs: each input byte read once and each output byte written once
    (pos and alpha 8 B and the output 8 B a (voice, frame), the windows 8 B
    a voice, and the bank samples the valid frames tap, each unique sample
    of both channels once), against the float32 work (per frame and
    channel: the int16 dequant of two taps, two products and a sum)."""
    sound, pos, _, win_a, win_b = args
    V, B = pos.shape
    region = region_rows(B, r_max)
    n = sound.shape[1]
    p = pos.long()
    valid = (p >= 0) & (p < 2 * region - 1)
    base_a = win_a.long()[:, None] * 512
    base_b = win_b.long()[:, None] * 512 - region
    taps = torch.cat([torch.where(t < region, base_a + t, base_b + t)[valid]
                      for t in (p, p + 1)])
    taps = taps[(taps >= 0) & (taps < n)]
    unique = int(torch.unique(taps).numel())
    nbytes = 16 * V * B + 8 * V + unique * 2 * sound.element_size()
    ops = V * B * 2 * (3 + (2 if sound.dtype == torch.int16 else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "unique_taps": unique,
            "valid_frames": int(valid.sum()),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def mixdown_bound(contrib, lane, init=None) -> dict:
    """The least time the card could take for one lane mixdown on these
    inputs: contrib, lane and init (when given) read once and the
    [.., 12, B, 2] output written once, against one float32 add per slice,
    voice with a lane in [0, 12), frame and channel."""
    H = contrib.shape[0] if contrib.dim() == 4 else 1
    B = contrib.shape[-2]
    out_bytes = H * 12 * B * 2 * 4
    nbytes = (contrib.numel() * 4 + lane.numel() * 4 + out_bytes
              + (out_bytes if init is not None else 0))
    laned = int(((lane >= 0) & (lane < 12)).sum())
    ops = laned * (H if lane.dim() == 1 else 1) * B * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
