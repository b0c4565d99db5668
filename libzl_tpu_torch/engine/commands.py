"""Clip and timer command records (the event ABI of the engine).

Python equivalents of the reference's pooled POD event structs:
- ClipCommand (lib/ClipCommand.h:11-92): start/stop flags plus
  change-flag+value pairs, channel conventions -2/-1/0..9, equivalence
  identity used for coalescing and voice matching (:33-39).
- TimerCommand (lib/TimerCommand.h:10-63): a 13-operation control event.

The reference pre-allocates 4096 of each and recycles them through lock-free
pools because allocation in an RT callback is forbidden
(lib/SyncTimer.cpp:267,298-332). The TPU build's scheduler runs on a host
thread with no RT constraint, so plain Python objects suffice; the *device*
never sees these — the host voice machine turns them into per-block program
tensors (engine/voicestate.py).

A copy of libzl_tpu/engine/commands.py, verbatim apart from this note: the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

# channel conventions (lib/ClipCommand.h:44-72)
CHANNEL_GLOBAL_UNEFFECTED = -2
CHANNEL_GLOBAL_EFFECTED = -1


@dataclasses.dataclass
class ClipCommand:
    clip_id: int = -1
    midi_note: int = -1
    midi_channel: int = -1
    start_playback: bool = False
    stop_playback: bool = False
    change_slice: bool = False
    slice: int = -1
    change_looping: bool = False
    looping: bool = False
    change_pitch: bool = False
    pitch_change: float = 0.0
    change_speed: bool = False
    speed_ratio: float = 0.0
    change_gain_db: bool = False
    gain_db: float = 0.0
    change_volume: bool = False
    volume: float = 0.0

    def equivalent_to(self, other: "ClipCommand") -> bool:
        """Identity for coalescing/matching (lib/ClipCommand.h:33-39)."""
        if self.clip_id != other.clip_id:
            return False
        if self.change_slice and other.change_slice:
            return self.slice == other.slice
        if not self.change_slice and not other.change_slice:
            return (
                self.midi_note == other.midi_note
                and self.midi_channel == other.midi_channel
            )
        return False

    def merge_from(self, other: "ClipCommand") -> None:
        """Coalescing merge on schedule (lib/SyncTimer.cpp:1014-1041)."""
        if other.change_looping:
            self.looping = other.looping
            self.change_looping = True
        if other.change_pitch:
            self.pitch_change = other.pitch_change
            self.change_pitch = True
        if other.change_speed:
            self.speed_ratio = other.speed_ratio
            self.change_speed = True
        if other.change_gain_db:
            self.gain_db = other.gain_db
            self.change_gain_db = True
        if other.change_volume:
            self.volume = other.volume
            self.change_volume = True
        if other.start_playback:
            self.start_playback = True

    # --- factories mirroring lib/ClipCommand.h:44-72 ---
    @staticmethod
    def no_effect(clip_id: int) -> "ClipCommand":
        return ClipCommand(clip_id=clip_id, midi_channel=CHANNEL_GLOBAL_UNEFFECTED,
                           midi_note=60)

    @staticmethod
    def effected(clip_id: int) -> "ClipCommand":
        return ClipCommand(clip_id=clip_id, midi_channel=CHANNEL_GLOBAL_EFFECTED,
                           midi_note=60)

    @staticmethod
    def channel(clip_id: int, channel_id: int) -> "ClipCommand":
        return ClipCommand(clip_id=clip_id, midi_channel=channel_id)


class Operation(enum.IntEnum):
    """lib/TimerCommand.h:13-28 (values preserved)."""

    INVALID = 0
    START_PLAYBACK = 1
    STOP_PLAYBACK = 2
    START_PART = 3
    STOP_PART = 4
    START_CLIP_LOOP = 6      # deprecated in the reference; accepted here
    STOP_CLIP_LOOP = 7       # deprecated in the reference; accepted here
    SAMPLER_CHANNEL_ENABLED_STATE = 8
    CLIP_COMMAND = 9
    SET_BPM = 10
    AUTOMATION = 11
    PASSTHROUGH_CLIENT = 12
    REGISTER_CAS = 10001
    UNREGISTER_CAS = 10002


# PassthroughClientOperation setting indices (lib/TimerCommand.h:25)
PASSTHROUGH_SETTING_DRY = 0
PASSTHROUGH_SETTING_WETFX1 = 1
PASSTHROUGH_SETTING_WETFX2 = 2
PASSTHROUGH_SETTING_PAN = 3
PASSTHROUGH_SETTING_MUTED = 4


@dataclasses.dataclass
class TimerCommand:
    operation: Operation = Operation.INVALID
    parameter: int = 0
    parameter2: int = 0
    parameter3: int = 0
    parameter4: int = 0
    big_parameter: int = 0
    data_parameter: Optional[Any] = None  # e.g. an embedded ClipCommand
