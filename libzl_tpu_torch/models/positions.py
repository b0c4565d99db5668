"""Per-clip playback positions model (ClipAudioSourcePositionsModel equivalent).

Tracks up to POSITION_COUNT live playback positions per clip — one per active
voice — with id, gain and progress (lib/ClipAudioSourcePositionsModel.cpp:5-12).
Voices publish peak*0.5 and progress once per block
(lib/SamplerSynthVoice.cpp:264-267); `peak_gain` is the max over positions
(:160-173), `first_progress` feeds the UI progress callback (:175-185), and a
staleness reaper drops orphans after 1 s (:191-209).

The model of libzl_tpu/models/positions.py with the same methods and
values, kept as one clip row of a FeedbackTable (models/feedback.py): the
positions live in the table's arrays, so an engine's session update
touches every clip's positions in one vectorised pass. A model made on
its own has a table of its own.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..constants import POSITION_COUNT, POSITION_ORPHAN_TIMEOUT_MS
from .feedback import CLIP_FIELDS, FeedbackTable


class PositionsModel:
    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._table = FeedbackTable(clock=clock)
        self._row = self._table.add_clip(self)
        # position id -> table row, in creation order
        self._rows: dict[int, int] = {}
        self._on_peak: Optional[Callable[[float], None]] = None
        self._on_first: Optional[Callable[[float], None]] = None

    @property
    def _clock(self) -> Callable[[], float]:
        return self._table.clock

    @property
    def on_peak_gain_changed(self) -> Optional[Callable[[float], None]]:
        return self._on_peak

    @on_peak_gain_changed.setter
    def on_peak_gain_changed(self, fn) -> None:
        self._on_peak = fn
        self._listen()

    @property
    def on_first_progress_changed(self) -> Optional[Callable[[float], None]]:
        return self._on_first

    @on_first_progress_changed.setter
    def on_first_progress_changed(self, fn) -> None:
        self._on_first = fn
        self._listen()

    def _listen(self) -> None:
        if self._on_peak is None and self._on_first is None:
            self._table.listened.discard(self._row)
        else:
            self._table.listened.add(self._row)

    def __len__(self) -> int:
        return len(self._rows)

    def create_position(self, position_id: int) -> None:
        if len(self._rows) >= POSITION_COUNT:
            # reference silently refuses beyond POSITION_COUNT
            return
        t = self._table
        row = self._rows.get(position_id)
        if row is None:
            self._rows[position_id] = t.add_position(
                self._row, position_id, self._clock())
        else:
            # a fresh position under an id in use keeps its place in order
            t.gain[row] = t.progress[row] = 0.0
            t.updated[row] = self._clock()

    def remove_position(self, position_id: int) -> None:
        row = self._rows.pop(position_id, None)
        if row is not None:
            self._table.free_position(row)

    def set_gain_and_progress(
        self, position_id: int, gain: float, progress: float
    ) -> None:
        row = self._rows.get(position_id)
        if row is None:
            return
        # one peak scan per side of the mutation, and only when someone
        # listens
        old_peak = self.peak_gain() if self._on_peak is not None else 0.0
        t = self._table
        t.gain[row] = float(gain)
        t.progress[row] = float(progress)
        t.updated[row] = self._clock()
        self._notify(old_peak)

    def set_many(self, ids, gains, progresses) -> None:
        """Batched update (one clock read, one peak-change check)."""
        now = self._clock()
        old_peak = self.peak_gain() if self._on_peak is not None else None
        t, rows = self._table, self._rows
        for pid, g, pr in zip(ids, gains, progresses):
            row = rows.get(pid)
            if row is None:
                continue
            t.gain[row] = g
            t.progress[row] = pr
            t.updated[row] = now
        self._notify(old_peak)

    def _notify(self, old_peak) -> None:
        """The listeners after an update: the peak's if it changed, the
        first progress's always."""
        if self._on_peak is not None:
            new_peak = self.peak_gain()
            if new_peak != old_peak:
                self._on_peak(new_peak)
        if self._on_first is not None:
            self._on_first(self.first_progress())

    def peak_gain(self) -> float:
        """Max gain over live positions (cpp:160-173)."""
        if not self._rows:
            return 0.0
        gain = self._table.gain
        return max(float(gain[row]) for row in self._rows.values())

    def first_progress(self) -> float:
        """Progress of the first position, or -1 when none (cpp:175-185)."""
        for row in self._rows.values():
            return float(self._table.progress[row])
        return -1.0

    def cleanup(self) -> int:
        """Reap positions not updated within the orphan timeout (cpp:191-209).
        Returns the number reaped."""
        cutoff = self._clock() - POSITION_ORPHAN_TIMEOUT_MS / 1000.0
        updated = self._table.updated
        stale = [pid for pid, row in self._rows.items()
                 if updated[row] < cutoff]
        self._forget(stale)
        return len(stale)

    def _forget(self, position_ids) -> None:
        for pid in position_ids:
            self.remove_position(pid)

    def _move_to(self, table: FeedbackTable, clip=None) -> None:
        """Carry this model's clip row and positions, in order, into
        `table` (FeedbackTable.attach / detach)."""
        old, old_row = self._table, self._row
        row = table.add_clip(self, clip)
        for name in CLIP_FIELDS:
            getattr(table, name)[row] = getattr(old, name)[old_row]
        rows = {}
        for pid, r in self._rows.items():
            new = rows[pid] = table.add_position(row, pid, old.updated[r])
            table.gain[new] = old.gain[r]
            table.progress[new] = old.progress[r]
            old.free_position(r)
        old.free_clip(old_row)
        self._table, self._row, self._rows = table, row, rows
        self._listen()
