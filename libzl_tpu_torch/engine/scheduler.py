"""The musical-time step ring (SyncTimer's scheduling core, host side).

The reference maintains a 32768-entry mlock'ed ring of per-tick StepData
(MIDI buffer + clip commands + timer commands, lib/SyncTimer.cpp:43-79,
267-288), written by UI/sequencer threads ahead of time and drained by the
JACK process callback with sample-accurate frame offsets (:452-702).

Here the ring is a plain Python list of Step objects; the consumer is the
block engine, which asks the BlockClock which ticks fall inside the next
block and drains exactly those steps with their frame offsets. No locking is
needed: the engine is single-host-threaded around the render dispatch, and
schedule-ahead pressure is handled by the block pipeline rather than an RT
tick thread.

Faithful semantics:
- clip-command coalescing on schedule (equivalentTo merge,
  lib/SyncTimer.cpp:1011-1048)
- stop() flush: un-played steps contribute their note-offs immediately and
  their clip commands are re-issued at delay 0 with volume forced to 0
  (lib/SyncTimer.cpp:881-929)
- 24-PPQN MIDI beat clock: one 0xF8 byte every 3rd tick (:97-99,516-520)

A copy of libzl_tpu/engine/scheduler.py, verbatim apart from this note: the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from ..constants import STEP_RING_SIZE, TICKS_PER_MIDI_BEAT_CLOCK
from .commands import ClipCommand, TimerCommand


@dataclasses.dataclass
class MidiEvent:
    """A raw MIDI message scheduled at a tick (bytes + origin metadata)."""

    data: bytes
    # reference MidiBuffer preserves insertion order within a step

    @property
    def is_note_off(self) -> bool:
        if not self.data:
            return False
        status = self.data[0] & 0xF0
        return status == 0x80 or (
            status == 0x90 and len(self.data) > 2 and self.data[2] == 0
        )


@dataclasses.dataclass
class Step:
    midi: list = dataclasses.field(default_factory=list)
    clip_commands: list = dataclasses.field(default_factory=list)
    timer_commands: list = dataclasses.field(default_factory=list)

    def is_empty(self) -> bool:
        return not (self.midi or self.clip_commands or self.timer_commands)

    def clear(self) -> None:
        self.midi.clear()
        self.clip_commands.clear()
        self.timer_commands.clear()


class StepRing:
    """Ring of future ticks, indexed by delay from the current read head."""

    def __init__(self, size: int = STEP_RING_SIZE):
        self._steps = [Step() for _ in range(size)]
        self._size = size
        self._read = 0  # index of the step for the *next* tick to play

    @property
    def size(self) -> int:
        return self._size

    def step_at(self, delay: int) -> Step:
        if delay >= self._size:
            raise ValueError(
                f"schedule delay {delay} exceeds ring capacity {self._size}"
            )
        if delay < 0:
            # a negative delay would wrap modulo ~32767 ticks into the far
            # future — surface the caller's arithmetic bug instead of
            # firing the event minutes late
            raise ValueError(f"schedule delay must be >= 0, got {delay}")
        return self._steps[(self._read + delay) % self._size]

    def schedule_clip_command(self, command: ClipCommand, delay: int = 0) -> bool:
        """Schedule with coalescing. Returns True if merged into an existing
        equivalent command (lib/SyncTimer.cpp:1011-1048)."""
        step = self.step_at(delay)
        for existing in step.clip_commands:
            if existing.equivalent_to(command):
                existing.merge_from(command)
                return True
        step.clip_commands.append(command)
        return False

    def schedule_timer_command(self, command: TimerCommand, delay: int = 0) -> None:
        self.step_at(delay).timer_commands.append(command)

    def schedule_midi(self, data: bytes, delay: int = 0) -> None:
        self.step_at(delay).midi.append(MidiEvent(bytes(data)))

    def pop_next(self) -> Step:
        """Consume the step at the read head and advance one tick."""
        step = self._steps[self._read]
        out = Step(
            midi=list(step.midi),
            clip_commands=list(step.clip_commands),
            timer_commands=list(step.timer_commands),
        )
        step.clear()
        self._read = (self._read + 1) % self._size
        return out

    def flush_for_stop(self) -> tuple[list[MidiEvent], list[ClipCommand]]:
        """Stop-time cleanup (lib/SyncTimer.cpp:881-929): collect pending
        note-offs (in order) and pending clip commands with volume forced to
        zero; every step is cleared. The caller delivers the note-offs
        immediately and re-schedules the zero-volume clip commands at delay 0.
        """
        note_offs: list[MidiEvent] = []
        zeroed: list[ClipCommand] = []
        for i in range(self._size):
            step = self._steps[(self._read + i) % self._size]
            if step.is_empty():
                continue
            for ev in step.midi:
                if ev.is_note_off:
                    note_offs.append(ev)
            for cmd in step.clip_commands:
                cmd.change_volume = True
                cmd.volume = 0.0
                zeroed.append(cmd)
            step.clear()
        return note_offs, zeroed


def midi_clock_due(tick: int) -> bool:
    """True when tick emits the 24-PPQN MIDI beat clock byte
    (every 3rd tick at 96 PPQN, lib/SyncTimer.cpp:97-99,516-520)."""
    return tick % TICKS_PER_MIDI_BEAT_CLOCK == 0
