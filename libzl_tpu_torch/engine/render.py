"""The per-block render graph on tensors (counterpart of
libzl_tpu/engine/render.py).

    sound_data [2,N] / [N,2] ─┐
    fused program [V, K] i32 ─┼─> render_voices ─> lane mix [12,B,2] ─> Σ master
    packed strips [5, 11]    ─┘        │                  │
                                 voice_peaks [V]    channel strips 1..10
                                                    global strip on master
                                                    peaks, RMS

PyTorch runs eagerly, so there is nothing to jit: `render_block_fused` is the
engine's per-block entry point, one program upload per block. The lookahead
horizon entry points (`render_horizon_*`) are not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from libzl_tpu.constants import DEFAULT_BLOCK_FRAMES

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
    pad = pad_voices_to - prog_fused.shape[0]
    if pad > 0:
        out = out._replace(
            voice_peaks=torch.nn.functional.pad(out.voice_peaks, (0, pad)))
    return out
