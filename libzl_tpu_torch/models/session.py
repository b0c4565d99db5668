"""Session checkpoint / resume.

The reference has no checkpointing (SURVEY.md §5: "Session state lives in
the Python UI above this library"); its closest artifacts are the cached
stretch renders and WAV recordings. This module makes session state
first-class: every clip's parameters, the strip fabric, MIDI routing table,
tempo and transport state serialize to a JSON document and restore into a
fresh engine — the groovebox "save project" the reference delegates to
zynthbox.

Audio payloads are referenced by file path (sources re-read on load;
playback buffers re-render from parameters), so checkpoints stay small and
diff-friendly.

A copy of libzl_tpu/models/session.py: the same JSON document (format
version 1), so a session saved by either package loads into the other. The
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

SESSION_FORMAT_VERSION = 1


def save_session(engine, path: str | Path) -> None:
    from .clip import all_clips

    clips = []
    for clip in all_clips():
        if clip.engine is not engine:
            continue
        # clips created from in-memory AudioData (filepath == "") must
        # still round-trip: embed the source audio in the checkpoint
        # (base64 f32 frames; a filepath-backed clip re-reads its file)
        embedded = None
        if not clip.filepath:
            import base64

            a = clip.source
            embedded = dict(
                sample_rate=int(a.sample_rate),
                channels=int(a.samples.shape[1]) if a.samples.ndim > 1 else 1,
                f32=base64.b64encode(
                    np.ascontiguousarray(a.samples, np.float32).tobytes()
                ).decode("ascii"),
            )
        clips.append(
            dict(
                id=clip.id,
                filepath=clip.filepath,
                embedded_audio=embedded,
                start_position_seconds=clip.start_position_seconds,
                length_seconds=clip.length_seconds,
                length_beats=clip.length_beats,
                speed_ratio=clip.speed_ratio,
                pitch_change=clip.pitch_change,
                gain_db=clip.gain_db,
                loop_crossfade_seconds=clip.loop_crossfade_seconds,
                volume_absolute=clip.volume_absolute,
                pan=clip.pan,
                adsr=[clip.adsr_attack, clip.adsr_decay,
                      clip.adsr_sustain, clip.adsr_release],
                slice_positions=list(clip.slice_positions),
                slice_base_midi_note=clip.slice_base_midi_note,
                keyzone=[clip.keyzone_start, clip.keyzone_end],
                root_note=clip.root_note,
                looping=clip.looping,
            )
        )
    routing = [
        dict(
            channel=out.input_channel,
            destination=int(out.destination),
            external_channel=out.external_channel,
            zynthian_channels=list(out.zynthian_channels),
        )
        for out in engine.router.outputs
    ]
    doc = dict(
        format_version=SESSION_FORMAT_VERSION,
        sample_rate=engine.sample_rate,
        block_frames=engine.block_frames,
        bpm=engine.bpm,
        transport_running=engine.transport_running,
        tick_position=int(engine.clock.tick_position),
        strips=dict(
            dry=engine.strips.dry.tolist(),
            wet1=engine.strips.wet1.tolist(),
            wet2=engine.strips.wet2.tolist(),
            pan=engine.strips.pan.tolist(),
            muted=engine.strips.muted.tolist(),
        ),
        lane_enabled=engine.lane_enabled.tolist(),
        clips=clips,
        routing=routing,
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2))


def load_session(engine, path: str | Path) -> dict:
    """Restore a checkpoint into `engine`. Returns {old_clip_id: new_clip}
    so callers can re-wire references."""
    from ..midi.router import Destination
    from .clip import ClipAudioSource

    doc = json.loads(Path(path).read_text())
    if doc.get("format_version", 0) > SESSION_FORMAT_VERSION:
        raise ValueError(
            f"session format {doc['format_version']} is newer than supported"
        )
    # geometry guard BEFORE any mutation: every seconds-based clip
    # parameter, the tick anchor, and the resumed position are computed
    # against the saving engine's sample rate — restoring them into a
    # different-rate engine silently retimes the whole session
    saved_rate = doc.get("sample_rate")
    if saved_rate is not None and saved_rate != engine.sample_rate:
        raise ValueError(
            f"session was saved at {saved_rate} Hz but this engine runs at "
            f"{engine.sample_rate} Hz — resample the session or build the "
            f"engine at the saved rate"
        )
    engine.set_bpm(doc["bpm"])
    for key, values in doc["strips"].items():
        getattr(engine.strips, key)[:] = values
    engine.lane_enabled[:] = doc["lane_enabled"]
    for entry in doc.get("routing", []):
        engine.router.set_channel_destination(
            entry["channel"],
            Destination(entry["destination"]),
            external_channel=entry["external_channel"],
            zynthian_channels=entry["zynthian_channels"],
        )
    id_map: dict[int, ClipAudioSource] = {}
    for c in doc["clips"]:
        emb = c.get("embedded_audio")
        if emb is not None:
            import base64

            from ..io.wav import AudioData

            data = np.frombuffer(
                base64.b64decode(emb["f32"]), np.float32
            ).reshape(-1, emb["channels"]).copy()
            clip = ClipAudioSource(
                engine, audio=AudioData(data, emb["sample_rate"])
            )
        else:
            # a moved/deleted sample must not abort the load with the
            # engine half-mutated: wait_for_file restores a silent
            # placeholder and polls (lib/SamplerSynthSound.cpp:55-58),
            # so the rest of the session still comes back
            clip = ClipAudioSource(engine, filepath=c["filepath"],
                                   wait_for_file=True)
        clip.start_position_seconds = c["start_position_seconds"]
        clip.length_seconds = c["length_seconds"]
        clip.length_beats = c["length_beats"]
        clip.set_volume_absolute(c["volume_absolute"])
        clip.set_pan(c["pan"])
        (clip.adsr_attack, clip.adsr_decay,
         clip.adsr_sustain, clip.adsr_release) = c["adsr"]
        clip.slice_positions = list(c["slice_positions"])
        clip.slice_base_midi_note = c["slice_base_midi_note"]
        clip.keyzone_start, clip.keyzone_end = c["keyzone"]
        clip.root_note = c["root_note"]
        clip.looping = bool(c.get("looping", True))
        # stretch/pitch/gain/crossfade re-render once, after all parameters
        clip.speed_ratio = c["speed_ratio"]
        clip.pitch_change = c["pitch_change"]
        clip.gain_db = c["gain_db"]
        clip.loop_crossfade_seconds = c.get("loop_crossfade_seconds", 0.0)
        if (c["speed_ratio"], c["pitch_change"], c["gain_db"],
                clip.loop_crossfade_seconds) != (1.0, 0.0, 0.0, 0.0):
            clip._update_playback()
        id_map[c["id"]] = clip
    # resume the musical position where the checkpoint left it: re-anchor the
    # tick<->sample mapping at the engine's current sample position
    engine.clock.tick_position = int(doc.get("tick_position", 0))
    engine.clock.anchor_tick = engine.clock.tick_position
    engine.clock.anchor_sample = float(engine.clock.sample_position)
    if doc.get("transport_running"):
        engine.start_transport()
    return id_map
