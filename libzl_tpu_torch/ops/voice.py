"""The voice render on tensors (device half of libzl_tpu/ops/voice.py).

All sampler voices for one block over a [V voices, B frames] grid: segment
positions, closed-form ADSR, the interpolated sample fetch (gather or the
windows kernel), gain, M/S pan, per-voice peaks and the one-hot lane
mixdown. The formulas, their f32 order and the reference's routing rules are
the reference's; see its module docstring for the semantics. The packed
program layout, `VoiceProgram`, `pack_program`, `fuse_packed` and
`pack_strips` are host-side numpy code and stay in the reference;
`unpack_program` and `unpack_strips` only slice columns, so the reference's
own functions unpack tensors as they are (re-exported here).
"""

from __future__ import annotations

import torch

from libzl_tpu.constants import MAX_SEGMENTS_PER_BLOCK, NUM_SAMPLER_CHANNELS
from libzl_tpu.ops.voice import (  # noqa: F401  (unpack_*: re-exported)
    _F32_ENV,
    _F32_SCALARS,
    VoiceProgram,
    unpack_program,
    unpack_strips,
)

from . import adsr as adsr_ops
from .fetch_windows import (
    _INT16_DEQUANT,
    SOUND_BLOCK,
    fetch_interp,
    parse_suffix,
    region_rows,
)

_F32 = torch.float32
_I32 = torch.int32


def split_fused(fused):
    """Inverse of fuse_packed: int32 [V, Ki+Kf] -> (ints [V, Ki] int32,
    floats [V, Kf] f32 bit-cast)."""
    ki = fused.shape[1] - (len(_F32_SCALARS) + len(_F32_ENV)
                           + MAX_SEGMENTS_PER_BLOCK)
    return fused[:, :ki], fused[:, ki:].view(torch.float32)


def positions_block(prog: VoiceProgram, block_frames: int):
    """Per-frame sample positions. Returns (pos_int [V,B] i32, alpha [V,B]
    f32, seg_idx [V,B] i32)."""
    k = torch.arange(block_frames, dtype=_I32,
                     device=prog.seg_start.device)[None, :]
    # segment index: count of segments whose start <= k, minus one
    seg_started = prog.seg_start[:, :, None] <= k[:, None, :]
    seg_idx = torch.clamp_min(seg_started.sum(dim=1, dtype=_I32) - 1, 0)
    # select the segment fields with masked sums over the (tiny, static) S
    # axis, as the reference does
    S = prog.seg_start.shape[1]
    m = seg_idx == 0
    s_start = prog.seg_start[:, 0:1] * m
    s_int = prog.seg_pos_int[:, 0:1] * m
    s_frac = prog.seg_pos_frac[:, 0:1] * m.to(_F32)
    for s in range(1, S):
        m = seg_idx == s
        s_start = s_start + prog.seg_start[:, s: s + 1] * m
        s_int = s_int + prog.seg_pos_int[:, s: s + 1] * m
        s_frac = s_frac + prog.seg_pos_frac[:, s: s + 1] * m.to(_F32)
    j = k - s_start  # frames into segment (>= 0 for frames >= start_frame)
    jc = torch.clamp_min(j, 0)
    # positional-loop containment past the segment horizon: wrap segments
    # repeat every loop_period frames, so j mod period is exact
    per = prog.loop_period[:, None]
    wrapseg = (seg_idx >= 1) & (per > 0)
    jc = torch.where(wrapseg, jc % torch.clamp_min(per, 1), jc)
    # beat-quantized containment: integer reset frames, applied in order
    # (later columns overwrite earlier ones)
    for e in range(prog.bq_reset.shape[1]):
        r_e = prog.bq_reset[:, e: e + 1]             # [V, 1], == B if unused
        jc = torch.where(k >= r_e, k - r_e, jc)
    frac_full = s_frac + jc.to(_F32) * prog.rate_frac[:, None]
    carry = torch.floor(frac_full)
    pos_int = s_int + jc * prog.rate_int[:, None] + carry.to(_I32)
    alpha = (frac_full - carry).to(_F32)
    return pos_int.to(_I32), alpha, seg_idx


def _gather_taps(sound_data, safe_pos0, safe_pos1):
    """(t0l, t0r, t1l, t1r) f32 from a planar [2, N] or interleaved [N, 2]
    bank, int16 dequantized x/32767."""
    i0, i1 = safe_pos0.long(), safe_pos1.long()
    if sound_data.shape[0] == 2:
        taps = (sound_data[0, i0], sound_data[1, i0],
                sound_data[0, i1], sound_data[1, i1])
    else:
        tap0, tap1 = sound_data[i0], sound_data[i1]
        taps = (tap0[..., 0], tap0[..., 1], tap1[..., 0], tap1[..., 1])
    if sound_data.dtype == torch.int16:
        taps = tuple(t.to(_F32) * _INT16_DEQUANT for t in taps)
    return taps


def render_voices(
    sound_data,           # [2, N] planar or [N, 2] interleaved, f32|int16
    prog: VoiceProgram,
    block_frames: int,
    quirk_gain: bool = False,
    num_lanes: int = NUM_SAMPLER_CHANNELS,
    return_contrib: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
):
    """Render all voices for one block.

    fetch: "gather" (tensor indexing) or "windows[:suffix]" (fetch_interp:
    the CUDA kernel for CUDA tensors, its plain version on the CPU; the
    windows path needs the planar bank with the region tail guard).
    Returns (mix [C, B, 2] f32, voice_peak [V] f32[, contrib [V, B, 2]])."""
    B = block_frames
    dev = sound_data.device
    k = torch.arange(B, dtype=_I32, device=dev)[None, :]

    pos_int, alpha, seg_idx = positions_block(prog, B)
    env = adsr_ops.envelope_block(
        prog.env, B, start_frame=prog.start_frame
    )  # [V, B], voice-local frame origin

    renders = (
        (prog.active[:, None] > 0)
        & (k >= prog.start_frame[:, None])
        & (k < prog.stop_frame[:, None])
    )
    # reference bounds rule: fetch only when sampleDuration > pos
    # (lib/SamplerSynthVoice.cpp:204); otherwise the frame contributes 0.
    valid = renders & (pos_int >= 0) & (pos_int < prog.len_minus1[:, None])

    g = (prog.gain[:, None] * env * prog.clip_volume[:, None]).to(_F32)
    inv_alpha = 1.0 - alpha

    if fetch.startswith("windows") and quirk_gain:
        # the reference-exact parity expression needs the taps separately;
        # parity testing is not a hot path — use the gather fetch
        fetch = "gather"
    if fetch.startswith("windows"):
        # the suffix only steers the TPU kernel's Mosaic schedule: validate
        # it like the reference, then ignore it
        parse_suffix(fetch.partition(":")[2])
        # window-relative addressing: segment 0 -> region A ([0, region)),
        # wrap segments -> region B (offset region)
        region = region_rows(B, max_pitch_ratio)
        in_a = seg_idx == 0
        anchor = torch.where(in_a, prog.win_blk_a[:, None],
                             prog.win_blk_b[:, None])
        pos_local = (
            pos_int
            + prog.base[:, None]
            - anchor * SOUND_BLOCK
            + torch.where(in_a, 0, region)
        ).to(_I32)
        interp = fetch_interp(
            sound_data, pos_local, alpha,
            prog.win_blk_a.contiguous(), prog.win_blk_b.contiguous(),
            r_max=max_pitch_ratio,
        )  # [V, 2, B] planar
        l = interp[:, 0, :] * g
        r = interp[:, 1, :] * g
    else:
        # Both taps are clamped into the sound's own region; lanes where the
        # clamp changed anything are masked off by `valid` above.
        lm1 = prog.len_minus1[:, None]
        base = prog.base[:, None]
        safe_pos0 = torch.minimum(torch.clamp_min(pos_int, 0), lm1) + base
        safe_pos1 = torch.minimum(torch.clamp_min(pos_int + 1, 0), lm1) + base
        t0l, t0r, t1l, t1r = _gather_taps(sound_data, safe_pos0, safe_pos1)
        if quirk_gain:
            # Reference-exact expression: gain chain on the second tap only
            # (lib/SamplerSynthVoice.cpp:204-205).
            l = t0l * inv_alpha + t1l * alpha * g
            r = t0r * inv_alpha + t1r * alpha * g
        else:
            l = (t0l * inv_alpha + t1l * alpha) * g
            r = (t0r * inv_alpha + t1r * alpha) * g
    l = torch.where(valid, l, 0.0)
    r = torch.where(valid, r, 0.0)

    # M/S panning (lib/SamplerSynthVoice.cpp:207-211)
    pan = prog.pan[:, None]
    l_pan = 0.5 * (1.0 + pan)
    r_pan = 0.5 * (1.0 - pan)
    m_sig = 0.5 * (l + r)
    s_sig = l - r
    l = l_pan * m_sig + s_sig
    r = r_pan * m_sig - s_sig

    # per-voice peak: max of (l + r), floored at 0
    # (lib/SamplerSynthVoice.cpp:213)
    voice_peak = torch.clamp_min(torch.amax(l + r, dim=1), 0.0)

    contrib = torch.stack([l, r], dim=-1)  # [V, B, 2]

    # mixdown by sampler channel lane: one-hot [C, V] x [V, 2B] -> [C, B, 2]
    # (a plain f32 matmul, as the reference leaves this product to XLA)
    lanes = torch.arange(num_lanes, dtype=_I32, device=dev)[:, None]
    onehot = (lanes == prog.lane[None, :]).to(_F32)
    mix = torch.matmul(onehot, contrib.reshape(contrib.shape[0], -1))
    mix = mix.reshape(num_lanes, B, 2)

    if return_contrib:
        return mix, voice_peak, contrib
    return mix, voice_peak
