"""Volume fader curve (tracktion master-volume slider equivalent).

The reference maps clip volume through tracktion's fader position:
`setVolume(dB)` -> `decibelsToVolumeFaderPosition` with a hard clamp to
position 0 at or below -40 dB (lib/ClipAudioSource.cpp:313-326), and
`dBFromVolume(pos)` -> `volumeFaderPositionToDB` (lib/libzl.cpp:429). The
voice kernel consumes the raw *position* as `volumeAbsolute`
(lib/SamplerSynthVoice.cpp:189).

tracktion_engine's exact curve is not available (the submodule is an empty
mount point in the reference checkout), so this build standardizes on a
documented power-law fader:

    position p in [0, 1],  gain = p^2,  dB = 40 * log10(p)

Anchors: p=1 -> 0 dB, p=0.5 -> ~-12 dB, p -> 0 => -inf (floored at -100 dB,
matching the reference's observation that tracktion treats position 0 as
-100 dB, lib/ClipAudioSource.cpp:316-318). The -40 dB clamp-to-zero rule is
preserved exactly.

A copy of libzl_tpu/models/fader.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math

DB_FLOOR = -100.0
MUTE_THRESHOLD_DB = -40.0


def db_to_fader_position(db: float) -> float:
    """decibelsToVolumeFaderPosition with the reference's -40 dB mute rule."""
    if db <= MUTE_THRESHOLD_DB:
        return 0.0
    return min(10.0 ** (db / 40.0), 1.0)


def fader_position_to_db(position: float) -> float:
    """volumeFaderPositionToDB (dBFromVolume, lib/libzl.cpp:429)."""
    if position <= 0.0:
        return DB_FLOOR
    return max(40.0 * math.log10(min(position, 1.0)), DB_FLOOR)


def db_to_gain(db: float) -> float:
    return 10.0 ** (db / 20.0)
