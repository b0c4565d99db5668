"""Musical timebase: tick <-> time <-> sample conversions.

Pure host-side math (Python ints / float64) — this is the authoritative clock
of the engine. The TPU render kernel never sees absolute time; the host
converts everything to block-relative frame offsets before dispatch.

Semantics match the reference scheduler's formulas:
- ticks per quarter note = 96 (lib/SyncTimer.cpp:95)
- subbeatCountToNanoseconds(bpm, n) = n * 60e9 / (bpm * 96)
  (lib/SyncTimer.cpp:180-182)
- nanosecondsToSubbeatCount(bpm, ns) = ns / (60e9 / (bpm * 96)) using integer
  division of the per-tick nanosecond interval (lib/SyncTimer.cpp:184-186)
- subbeatCountToSeconds clamps bpm to [50, 200] (lib/SyncTimer.cpp:936-943)
- getInterval(bpm) = 60000 / (bpm * 96) milliseconds (lib/SyncTimer.cpp:931-933)
- schedule-ahead = ticks covering output latency + 1 (lib/SyncTimer.cpp:711-715)
- bar/beat/tick/bar-start bookkeeping at 4 beats per bar
  (lib/SyncTimer.cpp:649-659, 1163-1173)

A copy of libzl_tpu/timebase.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

from .constants import (
    BEAT_SUBDIVISIONS,
    BPM_MAXIMUM,
    BPM_MINIMUM,
    NANOSECONDS_PER_MINUTE,
    TICKS_PER_BAR,
)


def clamp_bpm(bpm: float) -> float:
    """Clamp tempo to the supported range (lib/SyncTimer.cpp:28-29)."""
    return max(BPM_MINIMUM, min(float(bpm), BPM_MAXIMUM))


def ticks_to_nanoseconds(bpm: float, ticks: float) -> float:
    """Duration of `ticks` scheduler ticks at `bpm`, in nanoseconds."""
    return (ticks * NANOSECONDS_PER_MINUTE) / (bpm * BEAT_SUBDIVISIONS)


def nanoseconds_to_ticks(bpm: float, nanoseconds: float) -> float:
    """Inverse of :func:`ticks_to_nanoseconds` (fractional ticks)."""
    return nanoseconds * (bpm * BEAT_SUBDIVISIONS) / NANOSECONDS_PER_MINUTE


def ticks_to_seconds(bpm: float, ticks: float) -> float:
    """Seconds spanned by `ticks` ticks; bpm clamped like the reference."""
    return ticks_to_nanoseconds(clamp_bpm(bpm), ticks) / 1e9


def seconds_to_ticks(bpm: float, seconds: float) -> float:
    """Fractional ticks spanned by `seconds`; bpm clamped like the reference."""
    return nanoseconds_to_ticks(clamp_bpm(bpm), seconds * 1e9)


def tick_interval_ms(bpm: int) -> int:
    """Integer milliseconds per tick (reference getInterval semantics)."""
    return 60000 // (int(bpm) * BEAT_SUBDIVISIONS)


def tick_interval_seconds(bpm: float) -> float:
    """Exact seconds per tick."""
    return 60.0 / (bpm * BEAT_SUBDIVISIONS)


def ticks_to_samples(bpm: float, ticks: float, sample_rate: float) -> float:
    """Fractional sample count spanned by `ticks` ticks at `bpm`."""
    return ticks_to_seconds(bpm, ticks) * sample_rate


def samples_to_ticks(bpm: float, samples: float, sample_rate: float) -> float:
    return seconds_to_ticks(bpm, samples / sample_rate)


def schedule_ahead_ticks(bpm: float, latency_seconds: float) -> int:
    """Ticks of schedule-ahead needed to cover `latency_seconds` of output
    latency, plus one guard tick (lib/SyncTimer.cpp:711-715).

    Integer arithmetic on purpose: the reference's nanosecondsToSubbeatCount
    divides by the FLOOR-truncated per-tick nanosecond interval (quint64
    division, lib/SyncTimer.cpp:184-186), which yields one tick MORE than
    exact float math whenever the interval doesn't divide the minute
    evenly — schedule-ahead must err long, not short."""
    interval_ns = int(
        NANOSECONDS_PER_MINUTE // (int(clamp_bpm(bpm)) * BEAT_SUBDIVISIONS)
    )
    return int(int(latency_seconds * 1e9) // max(interval_ns, 1)) + 1


def next_bar_delay(cumulative_tick: int) -> int:
    """Ticks until the next bar boundary from `cumulative_tick`.

    Matches the queue-clip-to-start rule (lib/SyncTimer.cpp:816-831): returns
    TICKS_PER_BAR when exactly on a bar start (schedule for the *next* bar).
    """
    return TICKS_PER_BAR - (cumulative_tick % TICKS_PER_BAR)


@dataclasses.dataclass(frozen=True)
class BarBeatTick:
    """Musical position decomposition (JACK BBT analog, 1-based bar/beat)."""

    bar: int
    beat: int       # 1..BEATS_PER_BAR
    tick: int       # 0..BEAT_SUBDIVISIONS-1
    bar_start_tick: int


def decompose_tick(cumulative_tick: int) -> BarBeatTick:
    """Split a cumulative tick count into bar/beat/tick the way the
    reference feeds the JACK timebase master (lib/SyncTimer.cpp:1163-1173)."""
    bar = cumulative_tick // TICKS_PER_BAR
    within = cumulative_tick % TICKS_PER_BAR
    beat = within // BEAT_SUBDIVISIONS
    tick = within % BEAT_SUBDIVISIONS
    return BarBeatTick(
        bar=bar + 1,
        beat=beat + 1,
        tick=tick,
        bar_start_tick=bar * TICKS_PER_BAR,
    )


@dataclasses.dataclass
class BlockClock:
    """Tracks the relationship between the sample clock (authoritative for the
    renderer) and the musical tick clock, block by block.

    The reference couples a free-running tick thread to the JACK frame clock
    through `jackPlayhead`/`cumulativeBeat` (lib/SyncTimer.cpp:397,503-513).
    Here the sample clock *is* the master: each render block spans
    `block_frames` samples; ticks due within a block get exact frame offsets.

    All arithmetic is integer/float64 on host; no drift is possible because
    tick boundaries are derived from the absolute sample position and the
    absolute musical position (in ticks) at the last tempo change.
    """

    sample_rate: float
    block_frames: int
    bpm: float = 120.0
    # absolute sample index of the start of the next block
    sample_position: int = 0
    # musical position: tick count reached so far
    tick_position: int = 0
    # sample time at which `anchor_tick` occurred (f64 samples, may be fractional)
    anchor_sample: float = 0.0
    anchor_tick: int = 0

    @property
    def samples_per_tick(self) -> float:
        return tick_interval_seconds(self.bpm) * self.sample_rate

    def set_bpm(self, bpm: float) -> None:
        """Change tempo effective at the current sample position. The musical
        anchor is moved so tick spacing changes without discontinuity
        (reference applies BPM changes at step boundaries,
        lib/SyncTimer.cpp:602-607)."""
        bpm = clamp_bpm(bpm)
        if bpm == self.bpm:
            return
        # Re-anchor at the exact time of the last emitted tick.
        self.anchor_sample = self.tick_time_samples(self.tick_position)
        self.anchor_tick = self.tick_position
        self.bpm = bpm

    def tick_time_samples(self, tick: int) -> float:
        """Absolute sample time of a (future or past) tick under current bpm."""
        return self.anchor_sample + (tick - self.anchor_tick) * self.samples_per_tick

    def ticks_in_next_block(self) -> list[tuple[int, int]]:
        """(tick_number, frame_offset) for every tick due in the next block.

        frame_offset is the integer frame within the block at which the tick
        fires; the reference computes the same offset from microsecond deltas
        (lib/SyncTimer.cpp:503-513).
        """
        block_start = float(self.sample_position)
        block_end = block_start + self.block_frames
        out: list[tuple[int, int]] = []
        t = self.tick_position
        while True:
            ts = self.tick_time_samples(t)
            if ts >= block_end:
                break
            if ts >= block_start:
                offset = int(ts - block_start)
                out.append((t, offset))
            t += 1
        return out

    def advance_block(self) -> None:
        """Move past one block: consume due ticks, advance sample clock."""
        block_end = self.sample_position + self.block_frames
        t = self.tick_position
        while self.tick_time_samples(t) < block_end:
            t += 1
        self.tick_position = t
        self.sample_position = block_end

    def position(self) -> BarBeatTick:
        return decompose_tick(self.tick_position)
