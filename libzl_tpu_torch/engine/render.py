"""The render graph on tensors (counterpart of libzl_tpu/engine/render.py).

    sound_data [2,N] / [N,2] ─┐
    fused program [V, K] i32 ─┼─> render_voices ─> lane mix [12,B,2] ─> Σ master
    packed strips [5, 11]    ─┘        │                  │
                                 voice_peaks [V]    channel strips 1..10
                                                    global strip on master
                                                    peaks, RMS

PyTorch runs eagerly, so there is nothing to jit. `render_block_fused` is the
per-block render of one program upload and `render_horizon_onebuf` the
lookahead horizon's (one upload of the base program and the compact dynamics
per H blocks); the engine dispatches both through parallel/sharding.py, on a
one-device mesh when it has none. A horizon is H calls of the same per-block
math, one per slice's program, so each slice is bit-identical to a per-block
render of that program. Every lane mix here, in a horizon slice and in a
sharded render is ops/mixdown.lane_mixdown's fold in pool voice order, so
all of them sum a lane's voices in one order; everything after it is
ops/finish.finish, whose master and RMS sums also run in one spelled-out
order, so a horizon's slices finished in one call equal per-block finishes.
On a card the windows render is five hand-written kernels: voice prep,
the fetch and voice post (ops/voice_render.py) once a block and shard, the
mixdown once a shard, the finish once a render.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..constants import DEFAULT_BLOCK_FRAMES
from ..ops import finish as finish_ops
from ..ops import mixer as mixer_ops
from ..ops import voice as voice_ops

NUM_STRIPS = 11  # GlobalPlayback + FXPassthrough-Channel1..10
# Lane layout (constants.channel_to_lane): 0 = global uneffected,
# 1 = global effected, 2..11 = sketchpad channels 1..10.
FIRST_CHANNEL_LANE = 2


class RenderOutputs(NamedTuple):
    master: Any        # [B, 2] final mix (global strip dry output)
    lane_mix: Any      # [12, B, 2] raw per-sampler-channel sums
    strip_dry: Any     # [11, B, 2] strip dry sends (0=global, 1..10=channels)
    strip_wet1: Any    # [11, B, 2]
    strip_wet2: Any    # [11, B, 2]
    lane_peaks: Any    # [12, 2] per-lane abs peaks
    lane_rms: Any      # [12, 2] per-lane RMS
    master_peak: Any   # [2]
    voice_peaks: Any   # [V] reference peak metric: max(l+r, 0)


def finish_block(lane_mix, strips: "torch.Tensor | mixer_ops.StripParams",
                 voice_peaks):
    """Everything downstream of the additive lane mixdown: strips, master,
    meters, in one call of ops/finish.finish (the kernel
    csrc/finish_block.cu on a card, its plain version on the CPU).

    lane_mix [12, B, 2] -> one RenderOutputs; a horizon's stacked
    [H, 12, B, 2] -> a tuple of H, one call for every slice (voice_peaks
    then holds each slice's peaks: voice_peaks[h]). strips: the packed
    [5, 11] tensor (ops/voice.pack_strips) or StripParams."""
    if not isinstance(strips, torch.Tensor):
        strips = torch.stack(list(strips))
    stacked = lane_mix.dim() == 4
    mix = lane_mix if stacked else lane_mix[None]
    dry, wet1, wet2, lane_peaks, lane_rms, master_peak = finish_ops.finish(
        mix.contiguous(), strips.contiguous())
    outs = tuple(
        RenderOutputs(
            master=dry[h, 0],
            lane_mix=mix[h],
            strip_dry=dry[h],
            strip_wet1=wet1[h],
            strip_wet2=wet2[h],
            lane_peaks=lane_peaks[h],
            lane_rms=lane_rms[h],
            master_peak=master_peak[h],
            voice_peaks=voice_peaks[h] if stacked else voice_peaks,
        )
        for h in range(mix.shape[0]))
    return outs if stacked else outs[0]


def pad_voice_peaks(outs, pad_voices_to: int, v_in: int):
    """Zero-pad voice_peaks [v_in] -> [pad_voices_to] (bucketed prefix
    dispatch renders a prefix of the pool). One RenderOutputs or a tuple of
    them."""
    pad = pad_voices_to - v_in
    if pad <= 0:
        return outs

    def one(o):
        return o._replace(
            voice_peaks=torch.nn.functional.pad(o.voice_peaks, (0, pad)))

    if isinstance(outs, RenderOutputs):  # a NamedTuple: check before tuple
        return one(outs)
    return tuple(one(o) for o in outs)


def render_block_math(
    sound_data,
    prog: voice_ops.VoiceProgram,
    strips: "torch.Tensor | mixer_ops.StripParams",
    block_frames: int,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
) -> RenderOutputs:
    """One block: render_voices, then finish_block."""
    lane_mix, voice_peaks = voice_ops.render_voices(
        sound_data, prog, block_frames, quirk_gain=quirk_gain, fetch=fetch,
        max_pitch_ratio=max_pitch_ratio,
    )
    return finish_block(lane_mix, strips, voice_peaks)


def render_block_fused(
    sound_data,
    prog_fused,
    strips_packed,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
    pad_voices_to: int = 0,
) -> RenderOutputs:
    """The per-block entry point: the program pair arrives as ONE int32
    tensor (ops/voice.fuse_packed) and the strips as one [5, 11] f32 tensor
    (pack_strips). `pad_voices_to` zero-pads voice_peaks to the full pool
    size when a prefix of the pool is rendered."""
    prog_ints, prog_floats = voice_ops.split_fused(prog_fused)
    prog = voice_ops.unpack_program(prog_ints, prog_floats)
    out = render_block_math(
        sound_data, prog, strips_packed, block_frames, quirk_gain=quirk_gain,
        fetch=fetch, max_pitch_ratio=max_pitch_ratio,
    )
    return pad_voice_peaks(out, pad_voices_to, prog_fused.shape[0])


def render_horizon_math(
    sound_data,
    progs,          # `slices` VoicePrograms (or ops/voice.HorizonSlice)
    strips: "torch.Tensor | mixer_ops.StripParams",
    block_frames: int,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
) -> tuple:
    """A lookahead horizon of consecutive blocks, one per program: the same
    render_block_math on each slice's own program, in slice order."""
    return tuple(
        render_block_math(
            sound_data, prog, strips, block_frames, quirk_gain=quirk_gain,
            fetch=fetch, max_pitch_ratio=max_pitch_ratio,
        )
        for prog in progs
    )


def render_horizon_fused(
    sound_data,
    prog_stack,
    strips_packed,
    block_frames: int,
    slices: int,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
    pad_voices_to: int = 0,
) -> tuple:
    """Stacked-program horizon: `prog_stack` is `slices` fused per-block
    programs concatenated on axis 1, [V, slices*K]. Not the engine's path;
    the explicit-program oracle the compact forms are held against."""
    K = prog_stack.shape[1] // slices
    progs = [
        voice_ops.unpack_program(
            *voice_ops.split_fused(prog_stack[:, h * K:(h + 1) * K]))
        for h in range(slices)
    ]
    outs = render_horizon_math(
        sound_data, progs, strips_packed, block_frames, quirk_gain=quirk_gain,
        fetch=fetch, max_pitch_ratio=max_pitch_ratio,
    )
    return pad_voice_peaks(outs, pad_voices_to, prog_stack.shape[0])


def render_horizon_compact(
    sound_data,
    base_fused,
    dyn,
    strips_packed,
    block_frames: int,
    slices: int,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
    pad_voices_to: int = 0,
) -> tuple:
    """A horizon from the base program [V, K] and the compact dynamics
    [V, 1+(H-1)*D] (ops/voice.pack_horizon_dynamics), bit-identical to
    render_horizon_fused on the full stacked programs. Slices 1..H-1 render
    from ops/voice.HorizonSlice sources: the windows path's voice prep reads
    them straight from the dynamics."""
    progs = voice_ops.horizon_sources(base_fused, dyn, slices)
    outs = render_horizon_math(
        sound_data, progs, strips_packed, block_frames, quirk_gain=quirk_gain,
        fetch=fetch, max_pitch_ratio=max_pitch_ratio,
    )
    return pad_voice_peaks(outs, pad_voices_to, base_fused.shape[0])


def render_horizon_onebuf(
    sound_data,
    hz_fused,
    strips_packed,
    block_frames: int,
    slices: int,
    base_cols: int,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
    pad_voices_to: int = 0,
) -> tuple:
    """The engine's horizon dispatch: render_horizon_compact with the base
    program and the dynamics concatenated into one int32 tensor
    [V, base_cols + 1+(H-1)*D], so a horizon is one upload."""
    return render_horizon_compact(
        sound_data, hz_fused[:, :base_cols], hz_fused[:, base_cols:],
        strips_packed, block_frames, slices, quirk_gain=quirk_gain,
        fetch=fetch, max_pitch_ratio=max_pitch_ratio,
        pad_voices_to=pad_voices_to,
    )
