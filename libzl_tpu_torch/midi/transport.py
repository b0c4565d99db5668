"""TransportManager: MIDI transport control + timebase publishing.

Equivalent of lib/TransportManager.{h,cpp}: the reference registers as JACK
timebase master (its BBT callback delegates to SyncTimer::setPosition,
lib/TransportManager.cpp:120-137), listens for MIDI realtime Start/Continue/
Stop on its input and schedules Start/StopPlayback timer commands
(:61-92), and emits a 0xF9 MIDI tick every 10 ms (:99-111).

Here the engine's BlockClock *is* the timebase; this object:
- consumes the router's passthrough stream each block and converts realtime
  bytes into scheduled timer commands,
- emits the 10 ms 0xF9 tick into the engine's MIDI output, paced by the
  sample clock,
- publishes the BBT position (position() -> BarBeatTick).

A copy of libzl_tpu/midi/transport.py, verbatim apart from this note: the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from ..constants import MIDI_TICK_BYTE
from ..engine.commands import Operation, TimerCommand
from ..timebase import BarBeatTick

TICK_INTERVAL_SECONDS = 0.010  # lib/TransportManager.cpp:99-111


class TransportManager:
    def __init__(self, engine):
        self.engine = engine
        self._next_tick_sample = 0.0

    def position(self) -> BarBeatTick:
        """BBT for external observers (the timebase-master callback analog)."""
        return self.engine.clock.position()

    def handle_passthrough(self, events: list[tuple[int, bytes]]) -> None:
        """MIDI realtime control (lib/TransportManager.cpp:61-92).

        The reference guards on the transport state — Start is ignored
        while running and Stop while stopped ("Spec says to ignore",
        TransportManager.cpp:71-86). The Stop guard matters here: a
        redundant 0xFC (common on sync chains) would otherwise flush the
        step ring and reset the musical position, destroying queued
        next-bar clip starts."""
        for _offset, data in events:
            if not data:
                continue
            byte = data[0]
            running = self.engine.transport_running
            if byte in (0xFA, 0xFB) and not running:   # start / continue
                self.engine.schedule_timer_command(
                    TimerCommand(operation=Operation.START_PLAYBACK), 0
                )
            elif byte == 0xFC and running:             # stop
                self.engine.schedule_timer_command(
                    TimerCommand(operation=Operation.STOP_PLAYBACK), 0
                )

    def emit_ticks(self, block_start_sample: int, block_frames: int,
                   midi_out: list) -> None:
        """Append 0xF9 ticks due within this block (10 ms cadence in sample
        time; the reference paces by wall clock from its process callback)."""
        interval = TICK_INTERVAL_SECONDS * self.engine.sample_rate
        end = block_start_sample + block_frames
        while self._next_tick_sample < end:
            if self._next_tick_sample >= block_start_sample:
                offset = int(self._next_tick_sample - block_start_sample)
                midi_out.append((offset, bytes([MIDI_TICK_BYTE])))
            self._next_tick_sample += interval

    def restart_transport(self) -> None:
        """lib/TransportManager.cpp:196-200."""
        self.engine.schedule_timer_command(
            TimerCommand(operation=Operation.STOP_PLAYBACK), 0
        )
        self.engine.schedule_timer_command(
            TimerCommand(operation=Operation.START_PLAYBACK), 0
        )
