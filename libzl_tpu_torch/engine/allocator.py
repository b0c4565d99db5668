"""Voice allocation: clip commands -> voice pool operations.

Reproduces SamplerChannel::handleCommand (lib/SamplerSynth.cpp:187-230):
- stop: release every voice whose sound AND command identity match
- start: claim the first idle voice, start the note
- neither: update all matching live voices (setCurrentCommand merge,
  lib/SamplerSynthVoice.cpp:58-98)

The reference caps polyphony at 8 voices per channel because each channel is
a separate JACK client with a fixed voice array (lib/SamplerSynth.cpp:23).
The TPU pool is one flat axis; `voices_per_lane` optionally reproduces the
cap (start commands beyond it are dropped, as the reference's loop simply
finds no idle voice).

A copy of libzl_tpu/engine/allocator.py, verbatim apart from this note: the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import channel_to_lane
from .commands import ClipCommand
from .voicestate import VoicePool


class VoiceAllocator:
    def __init__(self, pool: VoicePool, voices_per_lane: Optional[int] = None):
        self.pool = pool
        self.voices_per_lane = voices_per_lane

    def _matching_voices(self, cmd: ClipCommand) -> np.ndarray:
        p = self.pool
        m = p.active & (p.clip_id == cmd.clip_id) & (
            p.midi_channel == cmd.midi_channel
        )
        # equivalentTo identity (lib/ClipCommand.h:33-39)
        if cmd.change_slice:
            m &= p.has_slice & (p.slice_idx == cmd.slice)
        else:
            m &= ~p.has_slice & (p.midi_note == cmd.midi_note)
        return np.flatnonzero(m)

    def handle(self, cmd: ClipCommand, clip, current_tick: int,
               frame_offset: int = 0) -> None:
        """Apply one clip command. `clip` is the ClipAudioSource (sound
        lookup + parameters); may be None for stop commands of dead clips."""
        if cmd.stop_playback or cmd.start_playback:
            if cmd.stop_playback:
                for v in self._matching_voices(cmd):
                    self.pool.note_off(int(v), tail=True,
                                       frame_offset=frame_offset)
            if cmd.start_playback and clip is not None:
                self._start(cmd, clip, current_tick, frame_offset)
        else:
            for v in self._matching_voices(cmd):
                self._update(int(v), cmd, clip)

    def _start(self, cmd: ClipCommand, clip, current_tick: int,
               frame_offset: int) -> None:
        pool = self.pool
        lane = channel_to_lane(cmd.midi_channel)
        if self.voices_per_lane is not None:
            if (pool.active & (pool.lane == lane)).sum() >= self.voices_per_lane:
                return  # no idle voice on this channel: command is dropped
        idle = pool.idle_voices()
        if len(idle) == 0:
            return
        v = int(idle[0])
        slot = clip.slot
        slice_idx = cmd.slice if cmd.change_slice else -1
        start_sec = clip.get_start_position(slice_idx)
        stop_sec = clip.get_stop_position(slice_idx)
        # the reference passes clipCommand->volume as the start velocity
        # UNCONDITIONALLY (lib/SamplerSynth.cpp:211) — a start command
        # without change_volume starts at the struct default 0.0 (silent),
        # exactly as an ABI client imitating the reference structs expects
        volume = cmd.volume
        pool.note_on(
            v,
            clip_id=cmd.clip_id,
            midi_note=cmd.midi_note,
            midi_channel=cmd.midi_channel,
            lane=lane,
            base=slot.base,
            length=slot.length,
            source_rate=slot.sample_rate,
            root_note=clip.root_note,
            start_sec=start_sec,
            stop_sec=stop_sec,
            gain=volume,  # velocityToGain is identity (SamplerSynthVoice.cpp:11-18)
            clip_volume=clip.volume_absolute,
            pan=clip.pan,
            attack=clip.adsr_attack,
            decay=clip.adsr_decay,
            sustain=clip.adsr_sustain,
            release=clip.adsr_release,
            looping=cmd.looping,
            length_beats=clip.length_beats,
            start_tick=current_tick,
            slice_idx=slice_idx,
            has_slice=cmd.change_slice,
            frame_offset=frame_offset,
        )
        # register a playback position with the clip's model
        clip.positions_model.create_position(int(pool.position_id[v]))

    def _update(self, v: int, cmd: ClipCommand, clip=None) -> None:
        """Live-voice update merge (lib/SamplerSynthVoice.cpp:58-98). Pitch
        and speed changes affect only the clip's offline render, never a live
        voice — matching the reference, whose pitchRatio is fixed at
        startNote."""
        pool = self.pool
        if cmd.change_looping:
            pool.looping[v] = cmd.looping
        if cmd.change_volume:
            pool.gain[v] = np.float32(cmd.volume)
        if cmd.change_slice:
            pool.slice_idx[v] = cmd.slice
            # the reference re-reads start/stopPosition(slice) each block
            # (lib/SamplerSynthVoice.cpp:190-191), so a slice change moves
            # the live loop points immediately
            if clip is not None:
                sr = pool.source_rate[v]
                pool.istart[v] = int(clip.get_start_position(cmd.slice) * sr)
                pool.stop[v] = int(clip.get_stop_position(cmd.slice) * sr)
        # no start_playback case here: handle() routes every start-flagged
        # command to _start (claim an idle voice), exactly like the
        # reference's handleCommand — its setCurrentCommand restart path
        # (lib/SamplerSynthVoice.cpp:87-92) is likewise only reached with
        # a freshly claimed voice, never a live one
