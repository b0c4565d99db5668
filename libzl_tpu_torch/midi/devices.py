"""MIDI hardware device abstraction.

The reference discovers hardware through JACK port-registration callbacks,
aliases ports to human-readable names and zynthian ids, and applies per-device
input filtering/CC translations (lib/MidiRouter.cpp:607-757, 788-824; up to
MAX_INPUT_DEVICES inputs, :191). This build abstracts devices behind a small
interface with two backends:

- VirtualMidiPort: in-memory queues — deterministic tests, virtual wiring
  between applications, and the default in containers with no sound stack.
- ALSA rawmidi (gated): opened via ctypes against libasound when present.

Device identifiers keep the "<client> <port>" shape the reference builds its
aliases from, so translation suffix-matching (translations.py) behaves the
same way.

A copy of libzl_tpu/midi/devices.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

from ..constants import MAX_MIDI_INPUT_DEVICES
from .translations import translations_for_device


class MidiPort:
    """Base interface: a named, directional MIDI endpoint."""

    def __init__(self, name: str, human_name: str = "", zynthian_id: str = ""):
        self.name = name
        self.human_name = human_name or name
        self.zynthian_id = zynthian_id or name
        self.enabled = True
        self.fb_enabled = False  # receives feedback routing (ENABLED_FB)

    def read(self) -> list[bytes]:
        raise NotImplementedError

    def write(self, events: Iterable[bytes]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class VirtualMidiPort(MidiPort):
    def __init__(self, name: str, **kw):
        super().__init__(name, **kw)
        self._queue: deque[bytes] = deque()

    def feed(self, *events: bytes) -> None:
        """Test/host-side injection of incoming events."""
        self._queue.extend(bytes(e) for e in events)

    def read(self) -> list[bytes]:
        out = list(self._queue)
        self._queue.clear()
        return out

    def write(self, events: Iterable[bytes]) -> None:
        self._queue.extend(bytes(e) for e in events)

    @property
    def written(self) -> list[bytes]:
        return list(self._queue)


class AlsaRawMidiPort(MidiPort):
    """ALSA rawmidi endpoint via the shared libasound binding (io/alsa.py,
    full restype/argtypes); available only where libasound exists — gated,
    containers without a sound stack use VirtualMidiPort. Test fakes inject
    via alsa.set_alsa_lib_for_testing."""

    def __init__(self, device: str, direction: str = "in", **kw):
        super().__init__(device, **kw)
        from ..io import alsa

        self._alsa = alsa
        self._handle = alsa.rawmidi_open(device, direction)
        self._direction = direction
        self._carry = b""  # trailing partial message from the last read

    def read(self) -> list[bytes]:
        if self._handle is None:
            return []
        raw = self._alsa.rawmidi_read(self._handle)
        if not raw:
            return []
        # carry a trailing partial message to the next read: the 256-byte
        # read boundary can land mid-message (a lone 0x9x status fragment
        # would otherwise crash the router, and split channel messages
        # would turn into spurious events)
        msgs, tail = _split_midi_stream(self._carry + raw)
        self._carry = tail
        return msgs

    def write(self, events: Iterable[bytes]) -> None:
        if self._handle is None:
            return
        for e in events:
            self._alsa.rawmidi_write(self._handle, bytes(e))

    def close(self) -> None:
        if self._handle is not None:
            self._alsa.rawmidi_close(self._handle)
            self._handle = None


def _split_midi_stream(raw: bytes) -> tuple[list[bytes], bytes]:
    """Split a raw byte stream into (complete messages, trailing partial).

    A real byte-stream parser, because real hardware demands it:
    - REALTIME bytes (0xF8-0xFF) may interrupt any message mid-flight
      (MIDI 1.0 spec) and clock-sending gear does so 24 times per quarter;
      they are emitted immediately as standalone events and excluded from
      the message they interrupt.
    - Known-length system commons (F1 ×2, F2 ×3, F3 ×2, F6 ×1) emit as
      soon as their last byte arrives — including exactly at a read
      boundary (a Song Position as a burst's final bytes must not sit in
      the carry until the device happens to send more).
    - SysEx includes its EOX terminator (F0 ... F7 as ONE event); a SysEx
      interrupted by a non-realtime status is dropped (spec: a new status
      cancels an unterminated SysEx).
    Running status is not supported — hardware we target sends full
    messages, like JACK normalizes. An incomplete message at the read
    boundary is returned as the trailing partial (realtime bytes already
    removed) so the caller prepends it to the next read; carries over 64
    bytes are dropped (runaway-SysEx bound)."""
    _COMMON_LEN = {0xF1: 2, 0xF2: 3, 0xF3: 2, 0xF6: 1}
    out: list[bytes] = []
    msg = bytearray()  # in-progress message (status + data so far)
    need = 0           # data bytes still missing; -1 = SysEx (until F7)
    for b in raw:
        if b >= 0xF8:              # realtime: emit through, never buffered
            out.append(bytes([b]))
            continue
        if b >= 0x80:              # status byte
            if msg and need == -1 and b == 0xF7:
                msg.append(b)      # EOX terminates the SysEx, included
                out.append(bytes(msg))
                msg = bytearray()
                continue
            # a new status cancels any incomplete message (malformed or
            # unterminated SysEx): drop it rather than emit a fragment
            msg = bytearray()
            if b == 0xF0:
                msg = bytearray([b])
                need = -1
            elif b >= 0xF0:
                size = _COMMON_LEN.get(b)
                if size is None:
                    continue       # F4/F5 undefined, stray F7: drop
                if size == 1:
                    out.append(bytes([b]))
                else:
                    msg = bytearray([b])
                    need = size - 1
            else:
                msg = bytearray([b])
                need = 1 if (b & 0xF0) in (0xC0, 0xD0) else 2
            continue
        # data byte
        if not msg:
            continue               # stray data byte, no message open
        msg.append(b)
        if need == -1:
            if len(msg) > 64:      # runaway unterminated SysEx
                msg = bytearray()
            continue
        need -= 1
        if need == 0:
            out.append(bytes(msg))
            msg = bytearray()
    return out, bytes(msg) if len(msg) < 64 else b""


class InputDeviceEntry:
    """Per-input-device routing state (lib/MidiRouter.cpp:607-693): CC
    translation table + note-stickiness bookkeeping."""

    def __init__(self, port: MidiPort):
        self.port = port
        self.cc_translations = translations_for_device(port.human_name)
        self.note_activations = [0] * 128
        self.active_note_channel = [0] * 128


class DeviceRegistry:
    """Tracks hardware inputs/outputs and their enablement, mirroring the
    env-var driven policy (DISABLED_IN / ENABLED_OUT / ENABLED_FB,
    lib/MidiRouter.cpp:990-1009)."""

    def __init__(self):
        self.inputs: list[InputDeviceEntry] = []
        self.outputs: list[MidiPort] = []
        self.disabled_in: list[str] = []
        self.enabled_out: list[str] = []
        self.enabled_fb: list[str] = []
        self.on_input_added = None
        self.on_input_removed = None
        self.on_output_added = None
        self.on_output_removed = None

    def add_input(self, port: MidiPort) -> Optional[InputDeviceEntry]:
        if len(self.inputs) >= MAX_MIDI_INPUT_DEVICES:
            return None
        entry = InputDeviceEntry(port)
        port.enabled = not any(
            port.zynthian_id.startswith(d) or port.name.startswith(d)
            for d in self.disabled_in
            if d
        )
        self.inputs.append(entry)
        if self.on_input_added is not None:
            self.on_input_added(port)
        return entry

    def remove_input(self, port: MidiPort) -> None:
        self.inputs = [e for e in self.inputs if e.port is not port]
        if self.on_input_removed is not None:
            self.on_input_removed(port)

    def add_output(self, port: MidiPort) -> None:
        port.enabled = any(
            port.zynthian_id.startswith(d) or port.name.startswith(d)
            for d in self.enabled_out
            if d
        )
        port.fb_enabled = self._fb_match(port)
        self.outputs.append(port)
        if self.on_output_added is not None:
            self.on_output_added(port)

    def remove_output(self, port: MidiPort) -> None:
        self.outputs = [p for p in self.outputs if p is not port]
        if self.on_output_removed is not None:
            self.on_output_removed(port)

    def _fb_match(self, port: MidiPort) -> bool:
        return any(
            port.zynthian_id.startswith(d) or port.name.startswith(d)
            for d in self.enabled_fb
            if d
        )

    def apply_port_policy(self) -> None:
        """Re-evaluate enablement after a configuration reload."""
        for entry in self.inputs:
            p = entry.port
            p.enabled = not any(
                p.zynthian_id.startswith(d) or p.name.startswith(d)
                for d in self.disabled_in
                if d
            )
        for p in self.outputs:
            p.enabled = any(
                p.zynthian_id.startswith(d) or p.name.startswith(d)
                for d in self.enabled_out
                if d
            )
            p.fb_enabled = self._fb_match(p)


class HardwareScanner:
    """ALSA rawmidi discovery + hot-plug.

    The reference gets JACK port-registration callbacks and connects new
    hardware on a 300 ms timer, aliasing ports to human-readable names and
    firing added/removed signals (lib/MidiRouter.cpp:788-824, 607-693).
    Without a port server to call us back, we poll the same 300 ms cadence:
    enumerate rawmidi endpoints, diff against what we know, open/close ports
    and fire the registry's on_input/output_added/removed callbacks.
    """

    def __init__(self, registry: DeviceRegistry, poll_interval: float = 0.3):
        self.registry = registry
        self.poll_interval = poll_interval
        self._known_in: dict[str, MidiPort] = {}
        self._known_out: dict[str, MidiPort] = {}
        # endpoints refused at MAX_MIDI_INPUT_DEVICES: skip re-opening a
        # real ALSA handle every poll until capacity frees or they unplug
        self._rejected_in: set[str] = set()
        self._next_poll = 0.0

    def due(self, now: Optional[float] = None) -> bool:
        """True when the 300 ms cadence has elapsed (and restarts it)."""
        import time

        now = time.monotonic() if now is None else now
        if now < self._next_poll:
            return False
        self._next_poll = now + self.poll_interval
        return True

    def poll(self, now: Optional[float] = None) -> bool:
        """Rescan if the cadence is due. Returns True if anything changed."""
        if not self.due(now):
            return False
        return self.rescan()

    def scan_hints(self) -> Optional[list[dict]]:
        """The slow half: enumerate rawmidi endpoints (blocking libasound
        call — run this OUTSIDE any realtime lock; the pump thread does).
        Returns None when no sound stack is present."""
        from ..io import alsa

        if not alsa.available():
            return None
        return alsa.enumerate_rawmidi()

    def rescan(self) -> bool:
        hints = self.scan_hints()
        if hints is None:
            return False
        return self.apply(hints)

    def apply(self, hints: list[dict]) -> bool:
        """The fast half: diff `hints` against known devices, open/close
        ports, fire callbacks. Safe to run under the engine lock."""
        seen_in: set[str] = set()
        seen_out: set[str] = set()
        changed = False
        for hint in hints:
            name, ioid = hint["name"], hint["ioid"]
            human = hint["desc"].split("\n")[0]
            if ioid in ("", "Input"):
                seen_in.add(name)
                if (name not in self._known_in
                        and name not in self._rejected_in):
                    changed |= self._open(name, "in", human)
            if ioid in ("", "Output"):
                seen_out.add(name)
                if name not in self._known_out:
                    changed |= self._open(name, "out", human)
        for name in list(self._known_in):
            if name not in seen_in:
                port = self._known_in.pop(name)
                self.registry.remove_input(port)
                port.close()
                changed = True
                # capacity freed: rejected endpoints may be admitted now
                self._rejected_in.clear()
        self._rejected_in &= seen_in  # unplugged rejects forget their state
        for name in list(self._known_out):
            if name not in seen_out:
                port = self._known_out.pop(name)
                self.registry.remove_output(port)
                port.close()
                changed = True
        return changed

    def _open(self, name: str, direction: str, human: str) -> bool:
        try:
            port = AlsaRawMidiPort(
                name, direction, human_name=human, zynthian_id=human
            )
        except RuntimeError:
            # busy or vanished between enumerate and open; the reference's
            # connector timer retries the same way — next poll will
            return False
        if direction == "in":
            if self.registry.add_input(port) is None:
                port.close()  # MAX_INPUT_DEVICES reached
                # remember the rejection: re-opening a real ALSA handle
                # 3.3x/s forever on every poll is wasted kernel I/O
                self._rejected_in.add(name)
                return False
            self._known_in[name] = port
        else:
            self.registry.add_output(port)
            self._known_out[name] = port
        return True
