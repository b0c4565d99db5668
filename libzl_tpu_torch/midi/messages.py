"""MIDI message helpers shared by the router/transport.

A copy of libzl_tpu/midi/messages.py, verbatim apart from this note: the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

NOTE_OFF = 0x80
NOTE_ON = 0x90
CC = 0xB0
SYSEX = 0xF0
SONG_POSITION = 0xF2
CLOCK = 0xF8
TICK = 0xF9
START = 0xFA
CONTINUE = 0xFB
STOP = 0xFC

REALTIME_FILTERED = {0xF2, 0xF8, 0xF9, 0xFA, 0xFB, 0xFC}


def status(data: bytes) -> int:
    return data[0] & 0xF0 if data and data[0] < 0xF0 else (data[0] if data else 0)


def channel(data: bytes) -> int:
    """Channel 0..15 for voice messages, -1 otherwise."""
    if data and 0x80 <= data[0] < 0xF0:
        return data[0] & 0x0F
    return -1


def is_note_message(data: bytes) -> bool:
    """Note on or off (reference test: 0x7F < byte1 < 0xA0,
    lib/MidiRouter.cpp:400)."""
    return bool(data) and 0x7F < data[0] < 0xA0


def is_note_on(data: bytes) -> bool:
    return bool(data) and (data[0] & 0xF0) == NOTE_ON and len(data) > 2 and data[2] > 0


def is_note_off(data: bytes) -> bool:
    if not data:
        return False
    st = data[0] & 0xF0
    return st == NOTE_OFF or (st == NOTE_ON and len(data) > 2 and data[2] == 0)


def is_cc(data: bytes) -> bool:
    return bool(data) and (data[0] & 0xF0) == CC


def with_channel(data: bytes, new_channel: int) -> bytes:
    """Return the message retargeted to another channel
    (lib/MidiRouter.cpp:523-526 arithmetic)."""
    if not data or not (0x80 <= data[0] < 0xF0):
        return data
    return bytes([data[0] - (data[0] & 0x0F) + (new_channel & 0x0F)]) + data[1:]


def note_on(note: int, velocity: int = 100, ch: int = 0) -> bytes:
    return bytes([NOTE_ON | (ch & 0xF), note & 0x7F, velocity & 0x7F])


def note_off(note: int, ch: int = 0) -> bytes:
    return bytes([NOTE_OFF | (ch & 0xF), note & 0x7F, 0])


def cc(controller: int, value: int, ch: int = 0) -> bytes:
    return bytes([CC | (ch & 0xF), controller & 0x7F, value & 0x7F])
