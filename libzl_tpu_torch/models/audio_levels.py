"""AudioLevels: system-wide metering + multi-track recording orchestration.

Python equivalent of lib/AudioLevels.{h,cpp}. The reference runs 13 JACK
tap clients (SystemCapture, SystemPlayback, SystemRecorder, Channel1-10,
lib/AudioLevels.cpp:279-318) and scans their buffers on a 50 ms timer with a
fixed-point x2^17 peak trick, dBFS conversion with a -200 floor, and a x0.9
peak-hold decay (:330-412). In the TPU build the per-block peaks arrive free
from the render graph (ops/meters.py); this object reproduces the fixed-point
accumulation, decay cadence and dBFS outputs, and owns the disk recorders:

- global playback recorder (record what the master plays, :514-534)
- port recorder with an editable port list (:462-499) — ports here are the
  engine's output taps, named "master", "lane:<n>", "strip:<n>:dry" etc.
- 10 per-channel recorders

Channel index map (reference ordering, lib/AudioLevels.cpp:347-412):
0 = capture, 1 = playback (with peak-hold), 2 = recorder, 3..12 = channels.

The model of libzl_tpu/models/audio_levels.py, with the same values: the
block fold and the analysis pass convert every meter to dBFS in array
operations (ops/meters.to_dbfs, add_dbfs), bit-equal to the
reference's value-by-value conversion.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    METER_DBFS_FLOOR,
    NUM_SAMPLER_CHANNELS,
    PEAK_HOLD_DECAY,
    PEAK_INT_DECAY_PER_TICK,
    PEAK_INT_SCALE,
    PEAK_INT_TO_FLOAT,
)
from ..engine.recorder import DiskRecorder, timestamped_filename
from ..ops.meters import add_dbfs, to_dbfs

NUM_METER_CHANNELS = 13
IDX_CAPTURE = 0
IDX_PLAYBACK = 1
IDX_RECORDER = 2
IDX_FIRST_CHANNEL = 3
NUM_TRACKS = 10


class AudioLevels:
    def __init__(self, engine):
        self.engine = engine
        self._peak_int = np.zeros((NUM_METER_CHANNELS, 2), np.int64)
        self._hold_signal = np.zeros(2, np.float64)  # playback peak-hold
        # published properties (dBFS)
        self.capture_a = self.capture_b = METER_DBFS_FLOOR
        self.playback_a = self.playback_b = METER_DBFS_FLOOR
        self.playback = METER_DBFS_FLOOR
        self.playback_a_hold = self.playback_b_hold = METER_DBFS_FLOOR
        self.recording_a = self.recording_b = METER_DBFS_FLOOR
        self.channels_a = [METER_DBFS_FLOOR] * NUM_TRACKS
        self.channels_b = [METER_DBFS_FLOOR] * NUM_TRACKS
        self.channels = [METER_DBFS_FLOOR] * NUM_TRACKS
        # instantaneous per-track RMS in dBFS (beyond the reference, which
        # meters peaks only; BASELINE.json configs ask for peak/RMS)
        self.channels_rms = [METER_DBFS_FLOOR] * NUM_TRACKS
        # recording state
        self.record_global_playback = False
        self.should_record_ports = False
        self.global_playback_prefix = ""
        self.ports_prefix = ""
        self.record_ports: list[tuple[str, int]] = []
        # the ports a LIVE take records (snapshotted at start_recording):
        # the WAV writer's channel count is fixed at start, so editing
        # record_ports mid-take must not change the width of the blocks
        # fed to it — the wave module would silently write the mismatched
        # interleave and garble the whole take. Edits apply to the next
        # take, like the reference's connect-at-start port wiring
        # (lib/AudioLevels.cpp:484-499).
        self._active_record_ports: list[tuple[str, int]] = []
        self._global_recorder = DiskRecorder()
        self._ports_recorder = DiskRecorder()
        self._channel_recorders = [DiskRecorder() for _ in range(NUM_TRACKS)]
        self.channels_to_record: list[int] = []
        # the channels a LIVE take records (snapshotted at start_recording,
        # same rule as _active_record_ports): removing a channel mid-take
        # must not starve its still-live recorder — and must not let
        # only_global_recording() flip True while it records, which would
        # engage the bounce drain's global-only feed and gap its file
        self._active_channels: list[int] = []
        self._channel_prefixes: list[str] = [""] * NUM_TRACKS

    # ------------------------------------------------------------- metering

    def ingest_capture(self, block: np.ndarray) -> None:
        """Feed one block of capture-path audio (the SystemCapture tap,
        lib/AudioLevels.cpp:279-299): folds into the capture meter slot and
        becomes resolvable as the "capture" record port. The pump calls this
        with the attached AudioSource's block each cycle."""
        block = np.asarray(block, np.float32)
        if block.ndim == 1:
            block = block[:, None]
        peaks = np.abs(block).max(axis=0)
        if peaks.shape[0] < 2:
            peaks = np.repeat(peaks, 2)
        ints = np.abs(peaks[:2] * PEAK_INT_SCALE).astype(np.int64)
        self._peak_int[IDX_CAPTURE] = np.maximum(
            self._peak_int[IDX_CAPTURE], ints
        )
        self._last_capture = block

    def ingest_block(self, outputs, peak_override=None,
                     rms_override=None) -> None:
        """Fold one block's peaks into the fixed-point accumulators
        (replaces the reference's buffer re-scan, lib/AudioLevels.cpp:356-383).
        `peak_override` — optional (lane_peaks, master_peak) already maxed
        over several blocks by the engine's peak queue; `rms_override` —
        optional pre-fetched lane_rms (both come batched in ONE transfer
        from AudioEngine.fetch_session_arrays).
        """
        if peak_override is not None:
            lane_peaks, master_peak = peak_override
        else:
            lane_peaks = np.asarray(outputs.lane_peaks)   # [12, 2]
            master_peak = np.asarray(outputs.master_peak)  # [2]
        # every slot but the capture's: playback, recorder (both the
        # master) and the channels, which sit on lanes 2..11
        # (constants.channel_to_lane); the scale is a power of two, so
        # the product is exact in either precision
        src = np.empty((NUM_METER_CHANNELS - 1, 2))
        src[IDX_PLAYBACK - 1] = src[IDX_RECORDER - 1] = master_peak
        src[IDX_FIRST_CHANNEL - 1:] = lane_peaks[2 : 2 + NUM_TRACKS]
        ints = np.abs(src * PEAK_INT_SCALE).astype(np.int64)
        np.maximum(self._peak_int[1:], ints, out=self._peak_int[1:])
        lane_rms = (rms_override if rms_override is not None
                    else np.asarray(outputs.lane_rms))
        track = lane_rms[2 : 2 + NUM_TRACKS]
        self.channels_rms = to_dbfs(
            np.maximum(track[:, 0], track[:, 1])).tolist()

    def analyze(self) -> None:
        """The 50 ms analysis pass (lib/AudioLevels.cpp:347-412): convert
        the held integer peaks to dBFS, then decay the residual for the
        NEXT tick. Order matters: the reference decays the held value
        before folding the current buffer, so the current block always
        displays at full value — decaying before conversion would
        under-read every meter by one decay step and pin steady signals
        below ~-22 dBFS at the floor."""
        peaks = self._peak_int.astype(np.float64) * PEAK_INT_TO_FLOAT
        self._peak_int = np.maximum(self._peak_int - PEAK_INT_DECAY_PER_TICK, 0)
        hold = self._hold_signal
        play = peaks[IDX_PLAYBACK]
        hold[:] = np.where(play >= hold, play, hold * PEAK_HOLD_DECAY)
        db = to_dbfs(np.concatenate((peaks, hold[None])))
        (self.capture_a, self.capture_b), (self.playback_a, self.playback_b), \
            (self.recording_a, self.recording_b) = db[:3].tolist()
        self.playback_a_hold, self.playback_b_hold = db[-1].tolist()
        # the playback pair and the channels' pairs, power-summed at once
        pairs = db[[IDX_PLAYBACK, *range(IDX_FIRST_CHANNEL,
                                         IDX_FIRST_CHANNEL + NUM_TRACKS)]]
        summed = add_dbfs(pairs[:, 0], pairs[:, 1]).tolist()
        self.playback = summed[0]
        self.channels_a[:] = pairs[1:, 0].tolist()
        self.channels_b[:] = pairs[1:, 1].tolist()
        self.channels[:] = summed[1:]

    # ------------------------------------------------------------ recording

    @property
    def is_recording(self) -> bool:
        return (
            self._global_recorder.is_recording
            or self._ports_recorder.is_recording
            or any(r.is_recording for r in self._channel_recorders)
        )

    def set_record_global_playback(self, should: bool) -> None:
        self.record_global_playback = bool(should)

    def set_global_playback_filename_prefix(self, prefix: str) -> None:
        self.global_playback_prefix = prefix

    def set_record_ports_filename_prefix(self, prefix: str) -> None:
        self.ports_prefix = prefix

    def add_record_port(self, port_name: str, channel: int) -> None:
        """lib/AudioLevels.cpp:462-481: (port, channel) pairs feed the
        ports recorder (one recorded channel per pair, like the
        reference's recordPorts.count()-channel writer).

        Validation happens HERE, on the API thread: a malformed name must
        raise to the caller, never inside the pump's per-block feed (100
        consecutive feed failures would kill audio entirely — the
        reference merely fails to connect an unknown JACK port)."""
        self._validate_port_name(port_name)
        pair = (port_name, int(channel))
        if pair not in self.record_ports:
            self.record_ports.append(pair)

    @staticmethod
    def _validate_port_name(port_name: str) -> None:
        if port_name in ("master", "capture") or port_name.startswith(
            ("system:playback", "system:capture")
        ):
            return
        if port_name.startswith("lane:"):
            lane = int(port_name.split(":")[1])
            if not 0 <= lane < NUM_SAMPLER_CHANNELS:
                raise ValueError(f"lane out of range 0..11: {port_name}")
            return
        if port_name.startswith("strip:"):
            _, idx, which = port_name.split(":")
            if which not in ("dry", "wet1", "wet2"):
                raise ValueError(f"unknown strip send: {port_name}")
            if not 0 <= int(idx) <= 10:
                raise ValueError(f"strip out of range 0..10: {port_name}")
            return
        # unknown names fall back to the master tap (reference: a failed
        # port connect records silence/last state, not a crash)

    def remove_record_port(self, port_name: str, channel: int) -> None:
        pair = (port_name, int(channel))
        if pair in self.record_ports:
            self.record_ports.remove(pair)

    def clear_record_ports(self) -> None:
        self.record_ports.clear()

    def set_should_record_ports(self, should: bool) -> None:
        self.should_record_ports = bool(should)

    def set_channels_to_record(self, channels: list[int]) -> None:
        self.channels_to_record = [c for c in channels if 0 <= c < NUM_TRACKS]

    def set_channel_to_record(self, channel: int, should: bool = True) -> None:
        """setChannelToRecord (lib/AudioLevels.h:135)."""
        if not 0 <= channel < NUM_TRACKS:
            return
        if should and channel not in self.channels_to_record:
            self.channels_to_record.append(channel)
        elif not should and channel in self.channels_to_record:
            self.channels_to_record.remove(channel)

    def set_channel_filename_prefix(self, channel: int, prefix: str) -> None:
        """setChannelFilenamePrefix (lib/AudioLevels.h:149)."""
        if 0 <= channel < NUM_TRACKS:
            self._channel_prefixes[channel] = prefix

    def start_recording(self) -> None:
        """lib/AudioLevels.cpp:514-560. Every recorder of the take shares
        ONE timestamp (the reference's single `timestamp` local), so a
        multi-track take's files group together across second boundaries."""
        from ..engine.recorder import recording_timestamp

        sr = self.engine.sample_rate
        stamp = recording_timestamp()
        # the port snapshot belongs to THIS take: reset unconditionally so a
        # take without port recording cannot inherit the previous take's list
        # (latent stale state — the feed guards on is_recording today, but
        # the snapshot fields must never disagree with the active take)
        self._active_record_ports = []
        if self.record_global_playback:
            self._global_recorder.start(
                timestamped_filename(self.global_playback_prefix,
                                     stamp=stamp), sr
            )
        if self.should_record_ports and self.record_ports:
            self._active_record_ports = list(self.record_ports)
            self._ports_recorder.start(
                timestamped_filename(self.ports_prefix, stamp=stamp), sr,
                channels=len(self._active_record_ports),
            )
        self._active_channels = list(self.channels_to_record)
        for c in self._active_channels:
            prefix = self._channel_prefixes[c] or (
                f"{self.ports_prefix}channel{c + 1}"
            )
            self._channel_recorders[c].start(
                timestamped_filename(prefix, stamp=stamp), sr
            )

    def stop_recording(self) -> None:
        self._global_recorder.stop()
        self._ports_recorder.stop()
        for r in self._channel_recorders:
            r.stop()
        # take-scoped snapshots die with the take (ADVICE r3: stale
        # _active_channels persisting after stop was latent state)
        self._active_record_ports = []
        self._active_channels = []

    def _resolve_port(self, outputs, port_name: str, channel: int) -> np.ndarray:
        """Map a record-port name to one mono stream [B].

        TOLERANT on purpose: this runs on the pump's per-block feed, where
        any exception drops the block and 100 in a row kill the pump — an
        unresolvable name records silence instead (the reference's failed
        jack_connect records a silent port)."""
        master = np.asarray(outputs.master)
        try:
            if (port_name == "master"
                    or port_name.startswith("system:playback")):
                return master[:, channel % 2]
            if (port_name == "capture"
                    or port_name.startswith("system:capture")):
                cap = getattr(self, "_last_capture", None)
                if cap is None or cap.shape[0] != master.shape[0]:
                    return np.zeros(master.shape[0], np.float32)
                return cap[:, channel % min(cap.shape[1], 2)]
            if port_name.startswith("lane:"):
                lane = int(port_name.split(":")[1])
                return np.asarray(outputs.lane_mix)[lane][:, channel % 2]
            if port_name.startswith("strip:"):
                _, idx, which = port_name.split(":")
                arr = {
                    "dry": outputs.strip_dry,
                    "wet1": outputs.strip_wet1,
                    "wet2": outputs.strip_wet2,
                }[which]
                return np.asarray(arr)[int(idx)][:, channel % 2]
            return master[:, channel % 2]
        except Exception:
            return np.zeros(master.shape[0], np.float32)

    def only_global_recording(self) -> bool:
        """True when the global-playback recorder is the ONLY active
        target — the bounce drain can then feed it from its own batched
        master fetch instead of per-block device syncs (capi/bridge)."""
        if not self._global_recorder.is_recording:
            return False
        if self._ports_recorder.is_recording and self._active_record_ports:
            return False
        return not any(
            self._channel_recorders[c].is_recording
            for c in self._active_channels
        )

    def feed_global_recorder(self, master_block: np.ndarray) -> None:
        """Push one already-fetched master block into the global recorder
        (the drain path's zero-extra-sync feed)."""
        if self._global_recorder.is_recording:
            self._global_recorder.push(master_block)

    def feed_recorders(self, outputs) -> None:
        """Push one rendered block into every active recorder."""
        if self._global_recorder.is_recording:
            self._global_recorder.push(np.asarray(outputs.master))
        if self._ports_recorder.is_recording and self._active_record_ports:
            # one recorded channel PER PORT, like the reference's
            # recordPorts.count()-channel writer (lib/AudioLevels.cpp:548);
            # the take's snapshot, NOT record_ports — mid-take edits must
            # not change the block width under the fixed-channel writer
            self._ports_recorder.push(np.stack(
                [self._resolve_port(outputs, *p)
                 for p in self._active_record_ports], axis=1))
        lane_mix = None
        for c in self._active_channels:
            rec = self._channel_recorders[c]
            if rec.is_recording:
                if lane_mix is None:
                    lane_mix = np.asarray(outputs.lane_mix)
                rec.push(lane_mix[2 + c])
