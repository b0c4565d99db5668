"""MidiRouter: the event routing fabric (lib/MidiRouter.{h,cpp} equivalent).

Routes two event streams per block:
- internal events (the engine scheduler's MIDI output — the SyncTimerIn path,
  lib/MidiRouter.cpp:388-455)
- hardware input devices (lib/MidiRouter.cpp:458-566)

Per-MIDI-channel routing table (ChannelOutput, lib/MidiRouter.cpp:79-98):
destination in {NONE, ZYNTHIAN, EXTERNAL, SAMPLER}, an external-channel remap
and a zynthian-channel fan-out list. Hardware note events are retargeted to
the router's `current_channel` with *note stickiness* — a note-off follows
the channel its note-on was retargeted to (noteActivations/activeNoteChannel,
lib/MidiRouter.cpp:506-527). Device CC translations rewrite transport CCs
into MIDI realtime bytes before routing (:491-499).

Outputs are callback sinks instead of JACK ports: `zynthian_out` (the synth
stack), `external_out` (fanned to enabled hardware outputs), and
`passthrough_out` (feeds the TransportManager). Listener callbacks replace
the reference's four lock-free rings + 5 ms QThread (:100-130, 894-918) —
the block engine is already out of the RT path, so callbacks can be direct.

Configuration follows the reference env vars (ZYNTHIAN_MIDI_FILTER_OUTPUT,
ZYNTHIAN_MIDI_PORTS with DISABLED_IN/ENABLED_OUT/ENABLED_FB,
lib/MidiRouter.cpp:984-1009), re-readable at runtime via
`reload_configuration` (the reloadZynthianConfiguration C API).

A copy of libzl_tpu/midi/router.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import os
from typing import Callable, Optional

from .devices import DeviceRegistry, InputDeviceEntry
from .messages import (
    REALTIME_FILTERED,
    channel,
    is_note_message,
    is_note_on,
    with_channel,
)
from .translations import apply_cc_translation

OUTPUT_CHANNEL_COUNT = 16


class Destination(enum.IntEnum):
    """lib/MidiRouter.h:51-56 (values preserved)."""

    NONE = 0
    ZYNTHIAN = 1
    EXTERNAL = 2
    SAMPLER = 3


class ChannelOutput:
    def __init__(self, input_channel: int):
        self.input_channel = input_channel
        self.destination = Destination.ZYNTHIAN
        self.external_channel = -1  # -1: keep the input channel
        self.zynthian_channels = [input_channel] + [-1] * 15


class MidiRouter:
    def __init__(self, registry: Optional[DeviceRegistry] = None,
                 auto_discover: Optional[bool] = None):
        from .devices import HardwareScanner

        self.outputs = [ChannelOutput(c) for c in range(OUTPUT_CHANNEL_COUNT)]
        self.current_channel = 0
        self.filter_midi_out = False
        self.registry = registry or DeviceRegistry()
        # hardware discovery/hot-plug: poll ALSA rawmidi endpoints on the
        # reference's 300 ms connector cadence (lib/MidiRouter.cpp:788-824);
        # enabled by default wherever libasound is loadable
        self.scanner = HardwareScanner(self.registry)
        if auto_discover is None:
            from ..io import alsa

            auto_discover = alsa.available()
        self.auto_discover = auto_discover
        # sinks: lists of (frame_offset, bytes)
        self.zynthian_out: list[tuple[int, bytes]] = []
        self.external_out: list[tuple[int, bytes]] = []
        self.passthrough_out: list[tuple[int, bytes]] = []
        self.feedback_out: list[tuple[int, bytes]] = []
        # watchdog accounting (MidiRouterWatchdog analog,
        # lib/MidiRouter.cpp:135-188 — compile-time disabled there, live
        # here): every event entering the fabric this block must reach a
        # terminal (a sink append or an intentional swallow). The engine
        # compares the two counts per block (AudioEngine.watchdog).
        self.in_count = 0         # events accepted this block
        self.accounted_count = 0  # events that reached a terminal
        # listeners (noteChanged analog): cb(source, frame_offset, data)
        self.note_listeners: list[Callable[[str, int, bytes], None]] = []
        self.reload_configuration()

    # --------------------------------------------------------------- config

    def reload_configuration(self) -> None:
        """Parse the zynthian env configuration
        (lib/MidiRouter.cpp:984-1009)."""
        # Parity note: the reference parses ZYNTHIAN_MIDI_FILTER_OUTPUT into
        # filterMidiOut but never consults it outside a debug print
        # (lib/MidiRouter.cpp:242,989,1012) — stored here for the same
        # observable behavior.
        try:
            self.filter_midi_out = bool(
                int(os.environ.get("ZYNTHIAN_MIDI_FILTER_OUTPUT", "0") or 0)
            )
        except ValueError:
            # QString::toInt yields 0 for non-numeric values — a stray
            # "true" in the environment must not abort engine construction
            self.filter_midi_out = False
        ports = os.environ.get(
            "ZYNTHIAN_MIDI_PORTS",
            "DISABLED_IN=\\nENABLED_OUT=ttymidi:MIDI_out\\nENABLED_FB=",
        )
        for option in ports.split("\\n"):
            parts = option.split("=")
            if len(parts) != 2:
                continue
            key, value = parts
            names = value.split(",") if value else []
            if key == "DISABLED_IN":
                self.registry.disabled_in = names
            elif key == "ENABLED_OUT":
                self.registry.enabled_out = names
            elif key == "ENABLED_FB":
                self.registry.enabled_fb = names
        self.registry.apply_port_policy()

    def set_channel_destination(
        self,
        midi_channel: int,
        destination: Destination,
        external_channel: int = -1,
        zynthian_channels: Optional[list[int]] = None,
    ) -> None:
        out = self.outputs[midi_channel]
        out.destination = Destination(destination)
        out.external_channel = external_channel
        if zynthian_channels is not None:
            z = list(zynthian_channels)[:16]
            out.zynthian_channels = z + [-1] * (16 - len(z))

    def set_zynthian_channels(self, channel: int,
                              zynthian_channels: list[int]) -> None:
        """setZynthianChannels (lib/MidiRouter.h:77): replace the fan-out
        list for one input channel without touching its destination."""
        z = list(zynthian_channels)[:16]
        self.outputs[channel].zynthian_channels = z + [-1] * (16 - len(z))

    # --------------------------------------------------------------- routing

    def _emit_note(self, source: str, offset: int, data: bytes) -> None:
        for cb in self.note_listeners:
            cb(source, offset, data)

    def begin_block(self) -> None:
        self.zynthian_out = []
        self.external_out = []
        self.passthrough_out = []
        self.feedback_out = []
        self.in_count = 0
        self.accounted_count = 0

    def route_internal(self, events: list[tuple[int, bytes]]) -> None:
        """Route the scheduler's own MIDI (SyncTimerIn path,
        lib/MidiRouter.cpp:388-455)."""
        for offset, data in events:
            if not data:
                continue
            self.in_count += 1
            ch = channel(data)
            if ch >= 0:
                out = self.outputs[ch]
                note = is_note_message(data)
                if note:
                    # controller-surface feedback: engine-originated note
                    # state mirrors to ENABLED_FB ports (the reference
                    # parses ENABLED_FB but never consults it,
                    # lib/MidiRouter.cpp:1004,1015 — this implements the
                    # zynthian-documented intent; PARITY.md #9)
                    self.feedback_out.append((offset, data))
                if out.destination == Destination.ZYNTHIAN:
                    if note:
                        self._emit_note("passthrough", offset, data)
                        self._emit_note("internal", offset, data)
                    for zch in out.zynthian_channels:
                        if zch == -1:
                            break
                        self.zynthian_out.append((offset, with_channel(data, zch)))
                    self.passthrough_out.append((offset, data))
                elif out.destination == Destination.SAMPLER:
                    if note:
                        self._emit_note("passthrough", offset, data)
                        self._emit_note("internal", offset, data)
                    self.passthrough_out.append((offset, data))
                elif out.destination == Destination.EXTERNAL:
                    ext = (
                        out.input_channel
                        if out.external_channel == -1
                        else out.external_channel
                    )
                    if note:
                        self._emit_note("passthrough", offset, data)
                        self._emit_note("external", offset, data)
                    self.external_out.append((offset, with_channel(data, ext)))
                    self.passthrough_out.append((offset, data))
                else:  # NONE: swallowed, internal listeners still informed
                    if note:
                        self._emit_note("internal", offset, data)
                self.accounted_count += 1
            elif data[0] == 0xF0:
                # sysex ignored (lib/MidiRouter.cpp:443-445) — an
                # intentional swallow still counts as accounted
                self.accounted_count += 1
            else:
                # system messages go external; timecode-ish bytes are not
                # fed back to the transport (lib/MidiRouter.cpp:447-452)
                self.external_out.append((offset, data))
                if data[0] not in REALTIME_FILTERED:
                    self.passthrough_out.append((offset, data))
                self.accounted_count += 1

    def route_hardware(self) -> None:
        """Drain every enabled hardware input and route with retargeting
        (lib/MidiRouter.cpp:458-566). Events are treated as block-start
        (offset 0) — hardware arrives between blocks.

        Discovery does NOT run here: route_hardware sits on the realtime
        render path (process_block, under the engine lock) and libasound's
        device enumeration blocks for milliseconds. The pump thread drives
        the scanner between blocks (capi/bridge._run), enumerating outside
        the lock — matching the reference, whose connector runs on its own
        300 ms timer, not in the process callback (lib/MidiRouter.cpp:813).
        Hosts without the pump call router.scanner.poll() themselves."""
        for entry in self.registry.inputs:
            if not entry.port.enabled:
                continue
            for data in entry.port.read():
                self._route_hardware_event(entry, 0, data)

    def _route_hardware_event(
        self, entry: InputDeviceEntry, offset: int, data: bytes
    ) -> None:
        self.in_count += 1
        data = apply_cc_translation(entry.cc_translations, data)
        ch = channel(data)
        if ch < 0:
            # realtime/system from hardware (incl. translated transport CCs)
            self.passthrough_out.append((offset, data))
            self.accounted_count += 1
            return
        target = self.current_channel
        if is_note_message(data) and len(data) > 1:
            note = data[1]
            # stickiness counts by STATUS byte, exactly like the reference
            # (MidiRouter.cpp:513-518: `byte1 >= 0x90` increments the
            # activation even for velocity-0 note-ons) — classifying v=0 as
            # an off here would reset the counter and retarget later
            # note-ons differently than the reference
            if (data[0] & 0xF0) == 0x90:
                entry.note_activations[note] += 1
                if entry.note_activations[note] == 1:
                    entry.active_note_channel[note] = self.current_channel
            else:
                entry.note_activations[note] = 0
            # stickiness: offs follow their on's channel (cpp:506-527)
            target = entry.active_note_channel[note]
            data = with_channel(data, target)
        out = self.outputs[target]
        note = is_note_message(data)
        if out.destination == Destination.ZYNTHIAN:
            if note:
                self._emit_note("passthrough", offset, data)
            for zch in out.zynthian_channels:
                if zch == -1:
                    break
                self.zynthian_out.append((offset, with_channel(data, zch)))
            self.passthrough_out.append((offset, data))
        elif out.destination == Destination.SAMPLER:
            if note:
                self._emit_note("passthrough", offset, data)
            self.passthrough_out.append((offset, data))
        elif out.destination == Destination.EXTERNAL:
            ext = (
                out.input_channel
                if out.external_channel == -1
                else out.external_channel
            )
            if note:
                self._emit_note("passthrough", offset, data)
                self._emit_note("external", offset, data)
            self.external_out.append((offset, with_channel(data, ext)))
            self.passthrough_out.append((offset, data))
        # a NONE-destination hardware channel swallows the event on purpose
        # (the reference's switch has no NONE case either); it still counts
        # as accounted — the watchdog flags LOST events, not routed-to-void
        self.accounted_count += 1
        if note:
            self._emit_note("hardware", offset, data)

    def flush_external(self) -> None:
        """Deliver external_out to every enabled hardware output
        (refreshOutputsList policy, lib/MidiRouter.cpp:696-757), and
        feedback_out to every ENABLED_FB port."""
        if self.external_out:
            events = [data for _, data in self.external_out]
            for port in self.registry.outputs:
                if port.enabled:
                    port.write(events)
        if self.feedback_out:
            events = [data for _, data in self.feedback_out]
            for port in self.registry.outputs:
                if getattr(port, "fb_enabled", False):
                    port.write(events)
