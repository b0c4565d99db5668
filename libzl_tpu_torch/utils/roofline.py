"""The least time the card could take for one call of each hand-written
kernel (the windows fetch, the lane mixdown, the voice prep and post and
the finish): the bytes its own inputs and output need at the H100's memory
rate against its float32 work at the card's peak (NVIDIA's data sheet, SXM
part).
`chip_smoke.py` and `libzl_tpu_torch.bench` print each kernel's measured
time beside these bounds."""

from __future__ import annotations

import torch

from ..ops.fetch_windows import region_rows

HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def _bound(nbytes: int, ops: int) -> dict:
    """The larger of the bytes' time at the memory rate and the float32
    work's at the card's peak."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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
    return {**_bound(nbytes, ops), "unique_taps": unique,
            "valid_frames": int(valid.sum())}


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
    return _bound(nbytes, laned * (H if lane.dim() == 1 else 1) * B * 2)


def _prep_ops(V: int, S: int, B: int) -> int:
    """The voice prep's float32 work a voice and frame: the segment
    fraction's masked sum, 2 S; the fraction, its floor and alpha, 4; the
    envelope, at most 8 with its exp2; the gain, 2."""
    return V * B * (2 * S + 14)


def voice_prep_bound(prog, block_frames: int) -> dict:
    """The least time the card could take for one voice prep on this
    program: each program column read once (4 B a voice and column: 22
    scalars, 3 S segment and W reset columns) and the outputs written once
    (pos_local, alpha and g 4 B, valid 1 B a voice and frame; the two
    window anchors 4 B a voice), against the float32 work (_prep_ops)."""
    V, S = prog.seg_start.shape
    W = prog.bq_reset.shape[1]
    B = block_frames
    return _bound(V * (22 + 3 * S + W) * 4 + 13 * V * B + 8 * V,
                  _prep_ops(V, S, B))


# the base program's columns a horizon slice reads (the rest come from the
# dynamics): base, len_minus1, win_blk_b, rate_int, rate_frac, gain,
# clip_volume, loop_period, a_rate, d_rate, sustain, inv_rel, rel_log2
SLICE_STATIC_COLUMNS = 13


def voice_prep_slice_bound(base, dyn, h: int, block_frames: int) -> dict:
    """The least time the card could take for the voice prep of slice h of
    a compact horizon: the slice's D words of the dynamics and its istart
    column read once, the base program's static columns once
    (SLICE_STATIC_COLUMNS, 4 B a voice each), the outputs written once (as
    voice_prep_bound), against the same float32 work."""
    from ..ops.voice import horizon_dyn_cols

    V, S = base.seg_start.shape
    D = horizon_dyn_cols(base.bq_reset.shape[1])
    B = block_frames
    return _bound(V * (SLICE_STATIC_COLUMNS + 1 + D) * 4 + 13 * V * B + 8 * V,
                  _prep_ops(V, S, B))


def voice_post_bound(interp, g, valid, pan) -> dict:
    """The least time the card could take for one voice post on these
    inputs: interp (8 B), g (4 B) and valid (1 B) a voice and frame and
    pan (4 B a voice) read once, the contributions (8 B a voice and frame)
    and the peaks (4 B a voice) written once, against 11 float32 operations
    a voice and frame (the gain, the M/S pan, the peak's sum and max)."""
    V, _, B = interp.shape
    return _bound(21 * V * B + 8 * V, 11 * V * B)


def finish_bound(lane_mix, strips_packed) -> dict:
    """The least time the card could take for one finish on these inputs
    ([H, L, B, 2] lane mix): the mix and the [5, L-1] strips read once, the
    three [H, L-1, B, 2] strip planes, the [H, L, 2] peaks and RMS and the
    [H, 2] master peak written once, against the float32 work a slice,
    frame and channel (the master's L-1 adds; a strip's scale and three
    sends, 4 a strip; a lane's abs, max, square and tree add, 4 a lane)."""
    H, L, B, _ = lane_mix.shape
    K = L - 1
    nbytes = (lane_mix.numel() * 4 + strips_packed.numel() * 4
              + 3 * H * K * B * 8 + 2 * H * L * 8 + H * 8)
    return _bound(nbytes, H * B * 2 * ((L - 1) + 4 * K + 4 * L))
