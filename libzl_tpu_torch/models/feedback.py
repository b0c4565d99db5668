"""The session feedback table: what the voices tell the clips, in arrays.

Every session update the voices publish peak*0.5 and progress to their
clip's playback positions (lib/SamplerSynthVoice.cpp:264-267), positions
idle for a second are reaped (lib/ClipAudioSourcePositionsModel.cpp:
191-209), and each clip publishes its first position's progress and its
decaying level through callbacks throttled to 100 ms and 30 ms
(lib/ClipAudioSource.cpp:88-113, 224-240). The table holds that state for
every clip of an engine:

- position rows: the owning clip row, the position id, gain, progress,
  the time of the last update and a creation sequence number (a clip's
  first position is its live row of lowest sequence, the order positions
  were made in). Rows come from a free list and the arrays grow on demand.
- clip rows: the level signal, the last published level and progress,
  when each may publish next, and the progress published while the clip
  has no position (its start over its duration, kept fresh by the clip).

`update` is the whole feedback of AudioEngine.update_session in one pass
of array operations. Python runs for one clip only where a positions
listener or a clip callback fires, or where one of its rows was reaped;
`updates` and `visits` count the passes and those clips.

`PositionsModel` (models/positions.py) is one clip row of a table and the
clip's properties read the same row. A clip outside an engine keeps a
table of its own; the engine's register_clip moves the clip's rows into
the engine's table (`attach`) and unregister_clip moves them out again
(`detach`).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ..constants import POSITION_COUNT, POSITION_ORPHAN_TIMEOUT_MS

PROGRESS_THROTTLE_S = 0.100   # lib/ClipAudioSource.cpp:237
LEVEL_THROTTLE_S = 0.030      # lib/ClipAudioSource.cpp:111
LEVEL_DECAY = 0.94            # positions-model peak fade (lib/ClipAudioSource.cpp:95)

# each clip row's fields and the values a new clip starts from
CLIP_FIELDS = {
    "level_signal": 0.0,
    "last_level": -400.0,
    "next_level_time": 0.0,
    "last_progress": -1.0,
    "next_progress_time": 0.0,
    "fallback": 0.0,
    "progress_cb": False,
    "level_cb": False,
}
# a free row's values: a free position is never stale, a free clip never
# due. The position arrays have one row more than the table holds, the
# last: voices without a position write there, and its `gen` is the
# table's version (what a voice without a position was looked up at)
_FREE_POSITION = {
    "owner": -1, "pid": 0, "gain": 0.0, "progress": 0.0, "updated": np.inf,
    "seq": 0, "gen": 0,
}
_FREE_CLIP = {**CLIP_FIELDS, "next_level_time": np.inf,
              "next_progress_time": np.inf, "order": 0}


def _grown(arr: np.ndarray, n: int, fill, tail: int = 0) -> np.ndarray:
    """`arr` in `n` rows: its first rows kept, the new ones `fill`, and its
    last `tail` rows moved to the end."""
    out = np.full(n, fill, arr.dtype)
    keep = arr.size - tail
    out[:keep] = arr[:keep]
    if tail:
        out[n - tail:] = arr[keep:]
    return out


class FeedbackTable:
    def __init__(self, positions: int = POSITION_COUNT, clips: int = 1,
                 clock: Optional[Callable[[], float]] = None):
        self.clock = clock or time.monotonic
        for name, fill in _FREE_POSITION.items():
            setattr(self, name, np.full(positions + 1, fill))
        for name, fill in _FREE_CLIP.items():
            setattr(self, name, np.full(clips, fill))
        self._free_rows = list(range(positions - 1, -1, -1))
        self._next_seq = 0
        self.models: list = [None] * clips   # the PositionsModel of a row
        self.clips: list = [None] * clips    # its clip, in an engine
        self._free_clips = list(range(clips - 1, -1, -1))
        self._next_order = 0
        self._clip_rows: dict[int, int] = {}  # attached clip id -> row
        self.listened: set[int] = set()       # rows with a positions listener
        # the live rows by clip, then creation (_peaks_and_first)
        self._layout = None
        self._vcache: Optional[dict] = None
        self.updates = 0
        self.visits = 0

    # ------------------------------------------------------------- rows

    def add_clip(self, model, clip=None) -> int:
        if not self._free_clips:
            n = len(self.models)
            for name, fill in _FREE_CLIP.items():
                setattr(self, name, _grown(getattr(self, name), 2 * n, fill))
            self.models += [None] * n
            self.clips += [None] * n
            self._free_clips = list(range(2 * n - 1, n - 1, -1))
        row = self._free_clips.pop()
        for name, fill in CLIP_FIELDS.items():
            getattr(self, name)[row] = fill
        self.order[row] = self._next_order
        self._next_order += 1
        self.models[row] = model
        self.clips[row] = clip
        if clip is not None:
            self._clip_rows[clip.id] = row
        self.gen[-1] += 1
        return row

    def free_clip(self, row: int) -> None:
        clip = self.clips[row]
        if clip is not None:
            self._clip_rows.pop(clip.id, None)
        for name, fill in _FREE_CLIP.items():
            getattr(self, name)[row] = fill
        self.models[row] = self.clips[row] = None
        self.listened.discard(row)
        self.gen[-1] += 1
        self._free_clips.append(row)

    def add_position(self, clip_row: int, position_id: int,
                     now: float) -> int:
        if not self._free_rows:
            n = self.owner.size - 1
            for name, fill in _FREE_POSITION.items():
                setattr(self, name,
                        _grown(getattr(self, name), 2 * n + 1, fill, tail=1))
            self._free_rows = list(range(2 * n - 1, n - 1, -1))
        row = self._free_rows.pop()
        self.owner[row] = clip_row
        self.pid[row] = position_id
        self.gain[row] = self.progress[row] = 0.0
        self.updated[row] = now
        self.seq[row] = self._next_seq
        self._next_seq += 1
        self.gen[-1] += 1
        self._layout = None
        return row

    def free_position(self, row: int) -> None:
        self.owner[row] = -1
        self.updated[row] = np.inf
        self.gen[row] += 1   # a voice's cached row no longer holds
        self._layout = None
        self._free_rows.append(row)

    def attach(self, clip) -> None:
        """Move a clip's rows into this table (AudioEngine.register_clip)."""
        if clip.positions_model._table is not self:
            clip.positions_model._move_to(self, clip)

    def detach(self, clip) -> None:
        """Move a clip's rows out into a table of its own
        (AudioEngine.unregister_clip): its positions and levels keep the
        values they had."""
        if clip.positions_model._table is self:
            clip.positions_model._move_to(FeedbackTable(clock=self.clock))

    # ----------------------------------------------------------- update

    def _voice_rows(self, pool, act: np.ndarray) -> np.ndarray:
        """Each active voice's position row, the table's last row where it
        has none, from a per-voice cache keyed by position id: only the
        voices whose note is new since the last update (or whose lookup
        may have changed) are looked up in Python."""
        n = pool.active.size
        c = self._vcache
        if c is None or c["pid"].size != n:
            c = self._vcache = {k: np.full(n, -1, np.int64)
                                for k in ("pid", "crow", "row", "stamp")}
        pids = pool.position_id[act]
        rows = c["row"][act]
        renew = (c["pid"][act] != pids) | (self.gen[rows] != c["stamp"][act])
        if np.count_nonzero(renew):
            for i in renew.nonzero()[0].tolist():
                v = int(act[i])
                pid = int(pids[i])
                crow = self._clip_rows.get(int(pool.clip_id[v]), -1)
                row = (self.models[crow]._rows.get(pid, -1)
                       if crow >= 0 else -1)
                c["pid"][v], c["crow"][v], c["row"][v] = pid, crow, row
                c["stamp"][v] = self.gen[row]
            rows = c["row"][act]
        return rows

    def update(self, pool, peaks: np.ndarray) -> None:
        """One session update of every attached clip: the active voices'
        peak*0.5 and progress into their positions, the orphans reaped,
        then each clip's progress and level, throttled, published. The
        listeners fire as PositionsModel.set_many fires them, clip by clip
        in ascending clip id; then, in registration order, each clip's
        progress callback and its level callback. `peaks`: [voices]."""
        now = self.clock()
        self.updates += 1
        visited = set()
        act = pool.active.nonzero()[0]
        if act.size:
            rows = self._voice_rows(pool, act)
            listened = []
            if self.listened:
                groups = self._vcache["crow"][act].tolist()
                listened = sorted(self.listened.intersection(groups),
                                  key=lambda r: self.clips[r].id)
                old = {r: self.models[r].peak_gain() for r in listened}
            self.gain[rows] = peaks[act] * 0.5
            self.progress[rows] = pool.progress()[act]
            self.updated[rows] = now
            self.updated[-1] = np.inf
            for row in listened:
                visited.add(row)
                self.models[row]._notify(old[row])
        stale = self.updated < now - POSITION_ORPHAN_TIMEOUT_MS / 1000.0
        if np.count_nonzero(stale):
            stale = stale.nonzero()[0]
            owners = self.owner[stale]
            for row in set(owners.tolist()):
                visited.add(row)
                reaped = self.pid[stale[owners == row]]
                self.models[row]._forget(reaped.tolist())
        peak, first = self._peaks_and_first()
        progress = np.where(first < 0, self.fallback, first)
        moved = self.next_progress_time <= now
        moved &= np.abs(progress - self.last_progress) > 0.001
        np.copyto(self.last_progress, progress, where=moved)
        np.copyto(self.next_progress_time, now + PROGRESS_THROTTLE_S,
                  where=moved)
        decayed = self.level_signal * LEVEL_DECAY
        signal = self.level_signal
        np.copyto(signal, peak)
        np.copyto(signal, decayed, where=decayed > peak)
        positive = signal > 0
        db = np.full(signal.size, -400.0)
        np.log10(signal, out=db, where=positive)
        np.multiply(db, 20.0, out=db, where=positive)
        leveled = self.next_level_time <= now
        leveled &= np.abs(db - self.last_level) > 0.1
        np.copyto(self.last_level, db, where=leveled)
        np.copyto(self.next_level_time, now + LEVEL_THROTTLE_S, where=leveled)
        fire_p = moved & self.progress_cb
        fire_l = leveled & self.level_cb
        fire = (fire_p | fire_l).nonzero()[0]
        for row in fire[np.argsort(self.order[fire])].tolist():
            clip = self.clips[row]
            if clip is None:
                continue  # a callback destroyed it
            visited.add(row)
            if fire_p[row] and clip.progress_callback is not None:
                clip.progress_callback(
                    float(progress[row]) * clip.get_duration())
            if fire_l[row] and clip.audio_level_callback is not None:
                clip.audio_level_callback(float(db[row]))
        self.visits += len(visited)

    def _peaks_and_first(self):
        """Per clip row: the max gain of its positions in creation order
        with Python's max (NaN only where the first is NaN; 0.0 without
        positions) and the first position's progress (-1.0 without)."""
        n = len(self.models)
        peak = np.zeros(n)
        first = np.full(n, -1.0)
        if self._layout is None:
            live = (self.owner >= 0).nonzero()[0]
            rows = live[np.lexsort((self.seq[live], self.owner[live]))]
            owner = self.owner[rows]
            starts = np.ones(rows.size, bool)
            np.not_equal(owner[1:], owner[:-1], out=starts[1:])
            starts = starts.nonzero()[0]
            self._layout = rows, starts, owner[starts], rows[starts]
        rows, starts, clips, heads = self._layout
        if rows.size:
            gain = self.gain[rows]
            lead = self.gain[heads]
            peak[clips] = np.fmax.reduceat(gain, starts)
            nan = lead != lead
            if np.count_nonzero(nan):
                peak[clips[nan]] = lead[nan]
            first[clips] = self.progress[heads]
        return peak, first
