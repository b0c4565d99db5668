"""ClipAudioSource: the session-level clip object model.

Python equivalent of lib/ClipAudioSource.{h,cpp}: one audio file with
start/length (in beats), speedRatio + pitchChange rendered offline into a
playback buffer (the tracktion render-then-play design,
lib/ClipAudioSource.cpp:384-413), gain/volume via the fader curve
(models/fader.py), pan (M/S, lib/ClipAudioSource.h:210-222), ADSR parameters
(defaults attack=0, release=0.05, lib/ClipAudioSource.cpp:164-168), 16 slices
with normalized positions (:490-560), keyzones + root note (:580-617), a
playback positions model, and progress / audio-level callbacks throttled to
100 ms / 30 ms (:225-240, 88-113).

The clip registers itself with the engine, which loads its playback buffer
into the device sound bank (the SamplerSynth registerClip analog,
lib/ClipAudioSource.cpp:196).

The model of libzl_tpu/models/clip.py, apart from where its session
feedback lives: the throttled progress and level state is the clip's row
of a FeedbackTable (models/feedback.py), which the clip's properties read
and write, so that an engine's session update publishes every clip's in
one vectorised pass and enters Python only for a callback. The render
worker times each render as span `clip_render` on the clip's engine's
profiler, on its own thread ("libzl-render").
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np

from ..constants import (
    BEAT_SUBDIVISIONS,
    DEFAULT_ADSR_ATTACK,
    DEFAULT_ADSR_DECAY,
    DEFAULT_ADSR_RELEASE,
    DEFAULT_ADSR_SUSTAIN,
    DEFAULT_KEYZONE_END,
    DEFAULT_KEYZONE_START,
    DEFAULT_ROOT_NOTE,
    DEFAULT_SLICE_COUNT,
)
from ..io.wav import AudioData, read_audio
from ..ops.resample import render_playback
from ..timebase import ticks_to_seconds
from .fader import db_to_fader_position, fader_position_to_db
from .feedback import LEVEL_DECAY, LEVEL_THROTTLE_S, PROGRESS_THROTTLE_S
from .positions import PositionsModel

_ids = itertools.count(1)
_registry: dict[int, "ClipAudioSource"] = {}

# ---------------------------------------------------------- render worker
# The reference renders stretch/pitch OFFLINE (tracktion needsRender ->
# playbackFileChanged, lib/ClipAudioSource.cpp:404-413) while the old
# playback file keeps playing. Same here: deferred re-renders run on this
# worker thread; the completed buffer is swapped in by the engine at the
# next block boundary (engine._pending_renders), so a sequenced
# change_pitch/speed/gain command never stalls the realtime block loop on
# a whole-clip STFT.
_render_queue = None
_render_thread = None


def _render_worker() -> None:
    import threading as _t

    # named for the span record (utils/profiling.thread_label)
    _t.current_thread().name = "libzl-render"
    while True:
        clip, gen = _render_queue.get()
        if clip is None:
            return
        if gen != clip._render_generation:
            continue  # superseded by a newer parameter change
        engine = clip.engine
        try:
            if engine is None:
                rendered = clip._compute_playback()
            else:
                # span clip_render on the engine's profiler, on this thread
                with engine.profiler.span("clip_render"):
                    rendered = clip._compute_playback()
        except Exception as exc:
            # a dropped render means the stale buffer keeps playing —
            # record and report it instead of vanishing (undebuggable
            # from the API surface otherwise)
            clip.last_render_error = exc
            import sys
            import traceback

            print(f"libzl_tpu clip {clip.id}: deferred render failed "
                  f"(stale playback buffer kept):", file=sys.stderr)
            traceback.print_exc()
            continue

        def done(clip=clip, gen=gen, rendered=rendered):
            clip._finish_playback_update(rendered, gen)

        if engine is not None:
            # applied at the start of the next process_block (the
            # playbackFileChanged reload analog) — single-threaded there
            engine._pending_renders.append(done)
        else:
            done()


def _ensure_render_worker() -> None:
    global _render_queue, _render_thread
    if _render_thread is None or not _render_thread.is_alive():
        import queue as _q
        import threading as _t

        _render_queue = _q.Queue()
        _render_thread = _t.Thread(target=_render_worker, daemon=True)
        _render_thread.start()


# ------------------------------------------------------------ file watcher
# The reference tolerates samples that do not exist yet: SamplerSynthSound
# polls a missing playback file every 100 ms until it appears
# (lib/SamplerSynthSound.cpp:55-58), and WaveFormItem retries thumbnail
# sources on a 200 ms timer (lib/WaveFormItem.cpp:130-143). Clips built
# with wait_for_file=True get the same behavior: a silent placeholder
# plays (nothing, at zero length) until the file lands, then the real
# audio is loaded off-thread and swapped in at a block boundary through
# the deferred-render path. Read failures (e.g. a file still being
# written) keep polling — the retry loop, not an error.
FILE_POLL_SECONDS = 0.1
_watch_lock = None
_watch_list: list = []  # clips with pending_file set
_watch_thread = None


def _file_watcher() -> None:
    import os as _os
    import time as _time

    while True:
        _time.sleep(FILE_POLL_SECONDS)
        with _watch_lock:
            entries = list(_watch_list)
        if not entries:
            continue
        done = []
        for clip in entries:
            # keyed on pending_file, NOT the render generation: parameter
            # changes (gain/pitch before the file lands — a normal UI
            # sequence) bump the generation and must not cancel the poll;
            # destroy() clears pending_file
            if not clip.pending_file:
                done.append(clip)  # attached or destroyed
                continue
            path = clip.filepath
            if not path or not _os.path.exists(path):
                continue
            try:
                audio = read_audio(path)
            except Exception:
                continue  # partial write: keep polling
            clip._attach_loaded_audio(audio)
            done.append(clip)
        if done:
            with _watch_lock:
                for e in done:
                    if e in _watch_list:
                        _watch_list.remove(e)


def _watch_file(clip: "ClipAudioSource") -> None:
    global _watch_lock, _watch_thread
    import threading as _t

    if _watch_lock is None:
        _watch_lock = _t.Lock()
    with _watch_lock:
        _watch_list.append(clip)
    if _watch_thread is None or not _watch_thread.is_alive():
        _watch_thread = _t.Thread(target=_file_watcher, daemon=True)
        _watch_thread.start()


def _row_field(name: str) -> property:
    """A clip attribute kept in the clip's row of its feedback table."""

    def get(self) -> float:
        m = self.positions_model
        return float(getattr(m._table, name)[m._row])

    def put(self, value: float) -> None:
        m = self.positions_model
        getattr(m._table, name)[m._row] = value

    return property(get, put)


def clip_by_id(clip_id: int) -> Optional["ClipAudioSource"]:
    """ClipAudioSource_byID (lib/libzl.cpp:107-116)."""
    return _registry.get(clip_id)


def all_clips() -> list["ClipAudioSource"]:
    return list(_registry.values())


class ClipAudioSource:
    def __init__(
        self,
        engine,
        filepath: Optional[str] = None,
        audio: Optional[AudioData] = None,
        muted: bool = False,
        wait_for_file: bool = False,
    ):
        pending_file = False
        if audio is None:
            if filepath is None:
                raise ValueError("need filepath or audio")
            import os as _os

            if wait_for_file and not _os.path.exists(filepath):
                # missing-file poll (lib/SamplerSynthSound.cpp:55-58): play
                # a silent placeholder until the file lands (_file_watcher)
                sr = engine.sample_rate if engine is not None else 48000
                audio = AudioData(
                    np.zeros((max(int(0.05 * sr), 1), 1), np.float32), sr
                )
                pending_file = True
            else:
                audio = read_audio(filepath)
        self.id = next(_ids)
        _registry[self.id] = self
        self.engine = engine
        self.filepath = filepath or ""
        # the clip's feedback row: set before the timing, whose setters
        # keep the row's fallback progress fresh
        self.positions_model = PositionsModel()
        self._start_position_seconds = 0.0
        self.source = audio

        # timing
        self.start_position_seconds = 0.0
        self.length_seconds = audio.duration_seconds
        self.length_beats = (
            audio.duration_seconds
            / ticks_to_seconds(engine.bpm if engine else 120, BEAT_SUBDIVISIONS)
            if engine
            else 0.0
        )
        # stretch / pitch / gain
        self.speed_ratio = 1.0
        self.pitch_change = 0.0
        self.gain_db = 0.0
        self.loop_crossfade_seconds = 0.0
        # mix
        self._volume_absolute = 0.0 if muted else db_to_fader_position(0.0)
        self.pan = 0.0
        # ADSR
        self.adsr_attack = DEFAULT_ADSR_ATTACK
        self.adsr_decay = DEFAULT_ADSR_DECAY
        self.adsr_sustain = DEFAULT_ADSR_SUSTAIN
        self.adsr_release = DEFAULT_ADSR_RELEASE
        # slices / keyzones
        self.slice_positions: list[float] = []
        self.slice_base_midi_note = 60
        self.keyzone_start = DEFAULT_KEYZONE_START
        self.keyzone_end = DEFAULT_KEYZONE_END
        self.root_note = DEFAULT_ROOT_NOTE
        # session plumbing
        self.progress_callback = None
        self.audio_level_callback = None
        self.last_render_error: Optional[Exception] = None
        self.playback_changed_callback: Optional[Callable[[], None]] = None

        self.playback_audio = audio  # replaced by renders
        self._render_generation = 0
        self.slot = None
        self.pending_file = pending_file
        if engine is not None:
            engine.register_clip(self)
        self.set_slices(DEFAULT_SLICE_COUNT)
        if pending_file:
            _watch_file(self)

    def _attach_loaded_audio(self, audio: AudioData) -> None:
        """File-watcher completion: the pending file exists and decoded.
        Update the source + timing fields, then hand the playback render to
        the deferred worker so the swap lands at a block boundary (the
        playbackFileChanged path, lib/ClipAudioSource.cpp:404-413)."""
        if not self.pending_file:
            return  # destroyed (or already attached) while polling
        # the deferred render below runs with the clip's CURRENT
        # parameters, so gain/pitch/speed set while the file was pending
        # apply to the first real render
        self.source = audio
        self.start_position_seconds = 0.0
        self.length_seconds = audio.duration_seconds
        self.length_beats = (
            audio.duration_seconds
            / ticks_to_seconds(
                self.engine.bpm if self.engine else 120, BEAT_SUBDIVISIONS)
            if self.engine
            else 0.0
        )
        self.pending_file = False
        self._update_playback(defer=True)

    # ------------------------------------------------------------- lifecycle

    def destroy(self) -> None:
        self._render_generation += 1  # drop any in-flight deferred render
        self.pending_file = False     # cancel the file watcher
        try:
            if self.engine is not None:
                self.stop(-3)
                self.engine.unregister_clip(self)
        finally:
            # the registry entry must go even if teardown raises —
            # engine-less clips previously leaked here (stop() touched
            # engine unconditionally)
            _registry.pop(self.id, None)

    # ------------------------------------------------------------ stretching

    def _compute_playback(self):
        """The pure render: stretch/pitch/gain + optional crossfade bake."""
        rendered = render_playback(
            self.source.samples,
            speed_ratio=self.speed_ratio,
            pitch_semitones=self.pitch_change,
            gain_db=self.gain_db,
            sample_rate=self.source.sample_rate,
        )
        if self.loop_crossfade_seconds > 0:
            from ..ops.resample import bake_loop_crossfade

            sr = self.source.sample_rate
            if rendered.ndim == 1:
                rendered = rendered[:, None]
            rendered = bake_loop_crossfade(
                rendered,
                int(self.get_start_position() * sr),
                min(int(self.get_stop_position() * sr), rendered.shape[0]),
                int(self.loop_crossfade_seconds * sr),
            )
        return rendered

    def _finish_playback_update(self, rendered, gen=None) -> None:
        """Swap the rendered buffer in (playbackFileChanged analog)."""
        if gen is not None and gen != self._render_generation:
            return  # a newer render superseded this one
        self.playback_audio = AudioData(rendered, self.source.sample_rate)
        if self.engine is not None and self.id in getattr(
            self.engine, "clips", {}
        ):
            self.engine.reload_clip_sound(self)
        if self.playback_changed_callback is not None:
            self.playback_changed_callback()

    def _update_playback(self, defer: bool = False) -> None:
        """Re-render the playback buffer (tracktion needsRender analog).

        defer=True hands the whole-clip STFT to the render worker and
        returns immediately — the old buffer keeps playing until the new
        one lands at a block boundary. Used by the engine's scheduled
        command path (realtime); direct API calls stay synchronous."""
        self._render_generation += 1
        if defer:
            _ensure_render_worker()
            _render_queue.put((self, self._render_generation))
            return
        self._finish_playback_update(
            self._compute_playback(), self._render_generation
        )

    # -------------------------------------------------------------- timing

    @property
    def source(self) -> AudioData:
        return self._source

    @source.setter
    def source(self, audio: AudioData) -> None:
        self._source = audio
        self._refresh_fallback()

    @property
    def start_position_seconds(self) -> float:
        return self._start_position_seconds

    @start_position_seconds.setter
    def start_position_seconds(self, seconds: float) -> None:
        self._start_position_seconds = seconds
        self._refresh_fallback()

    def _refresh_fallback(self) -> None:
        """The progress published while no position plays: the start over
        the duration, kept in the feedback row for the session update."""
        self._fallback = (self.start_position_seconds
                          / max(self.get_duration(), 1e-9))

    def get_duration(self) -> float:
        """Edit length in seconds (lib/ClipAudioSource.cpp:367)."""
        return self.source.duration_seconds

    def set_start_position(self, seconds: float) -> None:
        self.start_position_seconds = max(0.0, float(seconds))

    def set_length(self, beat: float, bpm: int) -> None:
        """Length given in beats at a bpm (lib/ClipAudioSource.cpp:352-360)."""
        self.length_seconds = ticks_to_seconds(bpm, beat * BEAT_SUBDIVISIONS)
        self.length_beats = float(beat)

    def get_start_position(self, slice_idx: int = -1) -> float:
        """lib/ClipAudioSource.cpp:261-268."""
        if 0 <= slice_idx < len(self.slice_positions):
            return (
                self.start_position_seconds
                + self.length_seconds * self.slice_positions[slice_idx]
            )
        return self.start_position_seconds

    def get_stop_position(self, slice_idx: int = -1) -> float:
        """lib/ClipAudioSource.cpp:270-277."""
        if 0 <= slice_idx and slice_idx + 1 < len(self.slice_positions):
            return (
                self.start_position_seconds
                + self.length_seconds * self.slice_positions[slice_idx + 1]
            )
        return self.start_position_seconds + self.length_seconds

    # ---------------------------------------------------------- stretch/pitch

    def set_speed_ratio(self, ratio: float, defer: bool = False) -> None:
        if not ratio > 0:
            # a negative/zero ratio would collapse the playback render to
            # ~1 frame (stretch factor 1/ratio) and destroy the clip's
            # audio with no error — refuse like an out-of-range header
            raise ValueError(f"speed ratio must be > 0: {ratio}")
        if ratio != self.speed_ratio:
            self.speed_ratio = float(ratio)
            self._update_playback(defer=defer)

    def set_pitch(self, semitones: float, defer: bool = False) -> None:
        if semitones != self.pitch_change:
            self.pitch_change = float(semitones)
            self._update_playback(defer=defer)

    def set_gain(self, db: float, defer: bool = False) -> None:
        if db != self.gain_db:
            self.gain_db = float(db)
            self._update_playback(defer=defer)

    def set_loop_crossfade(self, seconds: float, defer: bool = False) -> None:
        """Loop crossfade baked into the playback render (beyond the
        reference, whose loops hard-reset; ops/resample.bake_loop_crossfade).

        Scope: the crossfade is baked at the WHOLE-CLIP loop points
        (get_start/stop_position with slice -1). Slice-looped voices wrap at
        slice boundaries, where no crossfade exists — they still hard-reset
        like the reference. And because the blend is baked into the shared
        playback buffer, the crossfade window immediately before the clip
        stop position is audibly blended with the clip head for ANY voice
        that plays through it. Use 0 (the default) for material where that
        matters."""
        if seconds != self.loop_crossfade_seconds:
            self.loop_crossfade_seconds = max(float(seconds), 0.0)
            self._update_playback(defer=defer)

    # ----------------------------------------------------------------- mix

    def set_volume(self, db: float) -> None:
        """setVolume in dB with the -40 dB mute rule (cpp:313-326)."""
        self._volume_absolute = db_to_fader_position(db)

    def set_volume_absolute(self, pos: float) -> None:
        self._volume_absolute = min(max(float(pos), 0.0), 1.0)

    @property
    def volume_absolute(self) -> float:
        return self._volume_absolute

    def get_volume_db(self) -> float:
        return fader_position_to_db(self._volume_absolute)

    def set_pan(self, pan: float) -> None:
        self.pan = min(max(float(pan), -1.0), 1.0)

    # --------------------------------------------------------------- slices

    def set_slices(self, count: int) -> None:
        """Slice list resizing rules (lib/ClipAudioSource.cpp:495-528)."""
        current = len(self.slice_positions)
        if count == current:
            return
        if count == 0:
            self.slice_positions = []
        elif count < current:
            del self.slice_positions[count:]
        else:
            last = self.slice_positions[-1] if self.slice_positions else 0.0
            inc = (1.0 - last) / (count - current)
            if not self.slice_positions:
                self.slice_positions.append(0.0)
            pos = last + inc
            while len(self.slice_positions) < count:
                self.slice_positions.append(pos)
                pos += inc

    @property
    def slices(self) -> int:
        return len(self.slice_positions)

    def set_slice_position(self, idx: int, pos: float) -> None:
        if 0 <= idx < len(self.slice_positions):
            self.slice_positions[idx] = float(pos)

    def slice_for_midi_note(self, midi_note: int) -> int:
        """Rotation rule (lib/ClipAudioSource.cpp:575-578)."""
        n = len(self.slice_positions)
        if n == 0:
            return -1
        return ((n - (self.slice_base_midi_note % n)) + midi_note) % n

    # ------------------------------------------------------------ transport

    def play(self, loop: Optional[bool] = None, midi_channel: int = -2) -> None:
        """lib/ClipAudioSource.cpp:415-429. `loop=None` (the default)
        honors the clip-level `set_looping` flag, the way the reference's
        play() consults transport.looping (cpp:243-253); an explicit bool
        overrides per call."""
        from ..engine.commands import ClipCommand

        if loop is None:
            loop = self.looping
        cmd = ClipCommand.channel(self.id, midi_channel)
        cmd.midi_note = 60
        cmd.change_volume = True
        cmd.volume = 1.0
        cmd.looping = loop
        if loop:
            cmd.stop_playback = True
        cmd.start_playback = True
        self.engine.schedule_clip_command(cmd, 0)

    def stop(self, midi_channel: int = -2) -> None:
        """lib/ClipAudioSource.cpp:432-455: channel -3 means 'everywhere'."""
        from ..engine.commands import ClipCommand

        if midi_channel > -3:
            cmd = ClipCommand.channel(self.id, midi_channel)
            cmd.midi_note = 60
            cmd.stop_playback = True
            self.engine.schedule_clip_command(cmd, 0)
        else:
            for ch in [-2, -1, *range(10)]:
                cmd = ClipCommand.channel(self.id, ch)
                cmd.midi_note = 60
                cmd.stop_playback = True
                self.engine.schedule_clip_command(cmd, 0)

    @property
    def audio_level(self) -> float:
        """Measured clip level in dB (audioLevel property analog,
        lib/ClipAudioSource.cpp:88-113); updated by the engine's session
        update and by sync_audio_level."""
        return self._last_level

    # clip-level looping default used by play() when a command does not
    # specify it (the tracktion transport.looping analog,
    # lib/ClipAudioSource.cpp:243-253)
    looping = True

    def set_looping(self, looping: bool) -> None:
        self.looping = bool(looping)

    def get_looping(self) -> bool:
        return self.looping

    # ------------------------------------------------------------ callbacks

    # the throttled progress and level state: the clip's feedback row
    _level_signal = _row_field("level_signal")
    _last_level = _row_field("last_level")
    _next_level_time = _row_field("next_level_time")
    _last_progress = _row_field("last_progress")
    _next_progress_time = _row_field("next_progress_time")
    _fallback = _row_field("fallback")

    @property
    def progress_callback(self) -> Optional[Callable[[float], None]]:
        return self._progress_callback

    @progress_callback.setter
    def progress_callback(self, fn) -> None:
        self._progress_callback = fn
        m = self.positions_model
        m._table.progress_cb[m._row] = fn is not None

    @property
    def audio_level_callback(self) -> Optional[Callable[[float], None]]:
        return self._audio_level_callback

    @audio_level_callback.setter
    def audio_level_callback(self, fn) -> None:
        self._audio_level_callback = fn
        m = self.positions_model
        m._table.level_cb[m._row] = fn is not None

    def sync_progress(self, now: Optional[float] = None) -> None:
        """Throttled progress callback (lib/ClipAudioSource.cpp:224-240);
        the engine's session update does this for every clip at once
        (FeedbackTable.update)."""
        now = self.positions_model._clock() if now is None else now
        if now < self._next_progress_time:
            return
        progress = self.positions_model.first_progress()
        if progress < 0:
            progress = self._fallback
        if abs(progress - self._last_progress) > 0.001:
            self._last_progress = progress
            if self.progress_callback is not None:
                self.progress_callback(progress * self.get_duration())
            self._next_progress_time = now + PROGRESS_THROTTLE_S

    def sync_audio_level(self, now: Optional[float] = None) -> None:
        """Throttled, decay-faded audio level callback
        (lib/ClipAudioSource.cpp:88-113)."""
        now = self.positions_model._clock() if now is None else now
        self._level_signal = max(
            self.positions_model.peak_gain(), self._level_signal * LEVEL_DECAY
        )
        if now < self._next_level_time:
            return
        db = (
            20.0 * np.log10(self._level_signal)
            if self._level_signal > 0
            else -400.0
        )
        if abs(db - self._last_level) > 0.1:
            self._last_level = db
            if self.audio_level_callback is not None:
                self.audio_level_callback(db)
            self._next_level_time = now + LEVEL_THROTTLE_S
