"""MIDI note -> sampler clip mapping (keyzones, slices, velocity).

In the reference the sampler's JACK midiIn port is vestigial — notes reach
SamplerSynth only as ClipCommands built by the zynthbox UI layer from keyzone
and slice metadata the clip carries (keyZoneStart/End + rootNote,
lib/ClipAudioSource.cpp:580-617; sliceForMidiNote :575-578; SURVEY.md §3.4).
This object implements that layer inside the engine: clips are assigned to
sampler channels; note-ons on a SAMPLER-destination channel become
sample-accurate start commands for every assigned clip whose keyzone contains
the note, and note-offs stop them.

A copy of libzl_tpu/models/sampler_map.py, verbatim apart from this note:
the port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict

from ..engine.commands import ClipCommand
from ..midi.messages import channel as midi_channel
from ..midi.messages import is_note_off, is_note_on
from ..midi.router import Destination


class SamplerNoteMapper:
    def __init__(self, engine):
        self.engine = engine
        # sampler channel (0..9) -> list of clips
        self._assignments: dict[int, list] = defaultdict(list)
        # per-(channel, clip): use slice-for-note mode instead of pitch
        # tracking. Keyed per assignment, not per clip — the same clip can
        # sit on two channels with different modes
        self._slice_mode: dict[tuple[int, int], bool] = {}

    def assign(self, sampler_channel: int, clip, slice_mode: bool = False) -> None:
        if clip not in self._assignments[sampler_channel]:
            self._assignments[sampler_channel].append(clip)
        self._slice_mode[(sampler_channel, clip.id)] = slice_mode

    def unassign(self, sampler_channel: int, clip) -> None:
        if clip in self._assignments[sampler_channel]:
            self._assignments[sampler_channel].remove(clip)
        self._slice_mode.pop((sampler_channel, clip.id), None)

    def handle(self, router, passthrough: list[tuple[int, bytes]]) -> None:
        """Convert note events on SAMPLER-destination channels into clip
        commands applied at their in-block frame offsets."""
        for offset, data in passthrough:
            on = is_note_on(data)
            off = is_note_off(data)
            if not (on or off):
                continue
            ch = midi_channel(data)
            if ch < 0 or router.outputs[ch].destination != Destination.SAMPLER:
                continue
            if len(data) < 2:
                # a truncated status byte (VirtualMidiPort.feed accepts raw
                # bytes) must not crash the block loop — same guard class
                # as the router's len(data) > 1 checks
                continue
            note, velocity = data[1], data[2] if len(data) > 2 else 0
            for clip in self._assignments.get(ch, []):
                if not (clip.keyzone_start <= note <= clip.keyzone_end):
                    continue
                cmd = ClipCommand.channel(clip.id, ch)
                cmd.midi_note = note
                if self._slice_mode.get((ch, clip.id)) and clip.slices > 0:
                    cmd.change_slice = True
                    cmd.slice = clip.slice_for_midi_note(note)
                if on:
                    cmd.start_playback = True
                    cmd.change_volume = True
                    cmd.volume = velocity / 127.0
                else:
                    cmd.stop_playback = True
                self.engine._apply_clip_command(
                    cmd, self.engine.clock.tick_position, offset
                )
