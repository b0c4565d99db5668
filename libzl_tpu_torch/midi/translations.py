"""Per-device MIDI CC translation tables.

Reproduces lib/DeviceMessageTranslations.h:13-41: devices identified by name
suffix get a CC->message rewrite table applied to their input. The shipped
table maps the Presonus ATOM SQ's transport buttons (CC 85/86) to MIDI
realtime Stop (0xFC) / Start (0xFA).

A copy of libzl_tpu/midi/translations.py, verbatim apart from this note: the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional

PRESONUS_ATOM_SQ_SUFFIX = "ATM SQ ATM SQ"

_ATOM_SQ_CC = {
    85: bytes([0xFC]),  # stop
    86: bytes([0xFA]),  # start
}


def translations_for_device(identifier: str) -> dict[int, bytes]:
    """CC-number -> replacement message table for a device identifier
    (suffix match, lib/DeviceMessageTranslations.h:33-40)."""
    if identifier.endswith(PRESONUS_ATOM_SQ_SUFFIX):
        return dict(_ATOM_SQ_CC)
    return {}


def apply_cc_translation(
    table: dict[int, bytes], data: bytes
) -> Optional[bytes]:
    """Return the translated message for a CC event, the original message
    when no translation applies, or the replacement (which may be a realtime
    byte) when one does (lib/MidiRouter.cpp:491-499)."""
    if len(data) >= 2 and (data[0] & 0xF0) == 0xB0:
        replacement = table.get(data[1])
        if replacement is not None:
            return replacement
    return data
