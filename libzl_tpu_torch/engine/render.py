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
all of them sum a lane's voices in one order.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..constants import DEFAULT_BLOCK_FRAMES
from ..ops import meters as meter_ops
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


def finish_block(lane_mix, strips, voice_peaks) -> RenderOutputs:
    """Everything downstream of the additive lane mixdown: strips, master,
    meters."""
    master_raw = lane_mix.sum(dim=0)  # the JACK system:playback additive sum

    # Channel strips act on sketchpad-channel lanes 2..11; the global strip
    # acts on the summed master. Stack them so one op applies all 11.
    strip_in = torch.cat(
        [master_raw[None], lane_mix[FIRST_CHANNEL_LANE:]], dim=0
    )
    dry, wet1, wet2 = mixer_ops.apply_strips(strip_in, strips)
    master = dry[0]

    return RenderOutputs(
        master=master,
        lane_mix=lane_mix,
        strip_dry=dry,
        strip_wet1=wet1,
        strip_wet2=wet2,
        lane_peaks=meter_ops.block_peaks(lane_mix),
        lane_rms=meter_ops.block_rms(lane_mix),
        master_peak=meter_ops.block_peaks(master),
        voice_peaks=voice_peaks,
    )


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
    strips: mixer_ops.StripParams,
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
    strips = voice_ops.unpack_strips(strips_packed)
    out = render_block_math(
        sound_data, prog, strips, block_frames, quirk_gain=quirk_gain,
        fetch=fetch, max_pitch_ratio=max_pitch_ratio,
    )
    return pad_voice_peaks(out, pad_voices_to, prog_fused.shape[0])


def render_horizon_math(
    sound_data,
    progs,                      # sequence of `slices` VoicePrograms
    strips: mixer_ops.StripParams,
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
    strips = voice_ops.unpack_strips(strips_packed)
    progs = [
        voice_ops.unpack_program(
            *voice_ops.split_fused(prog_stack[:, h * K:(h + 1) * K]))
        for h in range(slices)
    ]
    outs = render_horizon_math(
        sound_data, progs, strips, block_frames, quirk_gain=quirk_gain,
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
    render_horizon_fused on the full stacked programs."""
    progs = voice_ops.horizon_programs(base_fused, dyn, slices, block_frames)
    strips = voice_ops.unpack_strips(strips_packed)
    outs = render_horizon_math(
        sound_data, progs, strips, block_frames, quirk_gain=quirk_gain,
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
