"""AudioEngine on PyTorch: the host block runtime with a torch device seam.

A fork of libzl_tpu/engine/engine.py, not a subclass: the reference engine
imports engine/render.py when it is loaded, and that module wraps every entry
point in `jax.jit`, so importing (let alone subclassing) the reference engine
loads JAX — which this package must never do. The fork keeps the reference's
host half as it is (clip admin, scheduling, transport, strips, the timer and
clip command handlers, the tick walk and MIDI fabric of process_block, the
session updates) and replaces the device seam: the sound bank and strips as
device tensors, one fused program upload per block, and the render through
`render.render_block_fused`.

    BlockClock (musical time)      StepRing (scheduled events)
          │                              │
          └──> process_block(): drain due ticks -> commands -> VoicePool
                    │
                    ├─ native host core / VoicePool.build_program ──> render
                    │     (fused program [V, K], one upload)         (torch)
                    └─ session updates (positions, meters) <────────────┘

Only the per-block path is ported. These reference options are rejected with
a ValueError until their ROADMAP item lands: `lookahead` (the horizon render
and the speculative chain), `voice_buckets`, `ratio_ladder` and `mesh`.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from libzl_tpu.constants import (
    BPM_MAXIMUM,
    BPM_MINIMUM,
    DEFAULT_BLOCK_FRAMES,
    DEFAULT_BPM,
    DEFAULT_NUM_VOICES,
    DEFAULT_SAMPLE_RATE,
    MIDI_BEAT_CLOCK_BYTE,
    NUM_SAMPLER_CHANNELS,
    PASSTHROUGH_CHANNEL_MAX,
    PASSTHROUGH_CHANNEL_MIN,
    SAMPLER_CHANNEL_MAX,
    SAMPLER_CHANNEL_MIN,
    channel_to_lane,
)
from libzl_tpu.engine.allocator import VoiceAllocator
from libzl_tpu.engine.commands import (
    PASSTHROUGH_SETTING_DRY,
    PASSTHROUGH_SETTING_MUTED,
    PASSTHROUGH_SETTING_PAN,
    PASSTHROUGH_SETTING_WETFX1,
    PASSTHROUGH_SETTING_WETFX2,
    ClipCommand,
    Operation,
    TimerCommand,
)
from libzl_tpu.engine.scheduler import StepRing, midi_clock_due
from libzl_tpu.engine.soundbank import SoundBank, region_tail_guard
from libzl_tpu.engine.voicestate import VoicePool
from libzl_tpu.midi.router import MidiRouter
from libzl_tpu.midi.transport import TransportManager
from libzl_tpu.models.audio_levels import AudioLevels
from libzl_tpu.models.sampler_map import SamplerNoteMapper
from libzl_tpu.ops.mixer import default_strip_params
from libzl_tpu.ops.voice import (
    _F32_SCALARS,
    _INT_SCALARS,
    pack_program,
    pack_strips,
)
from libzl_tpu.timebase import BlockClock, next_bar_delay, schedule_ahead_ticks
from libzl_tpu.utils.profiling import BlockProfiler, EventWatchdog

from .. import convert
from ..device import resolve_device
from ..ops.fetch_windows import parse_suffix
from . import render as render_mod


@dataclasses.dataclass
class BlockResult:
    """Host-visible outputs of one processed block."""

    outputs: render_mod.RenderOutputs   # tensors on the engine's device
    midi_out: list                      # [(frame_offset, bytes), ...]
    tick_count: int


def _reject_unported(lookahead, voice_buckets, ratio_ladder, mesh) -> None:
    """Reference options whose machinery is not ported yet fail loudly."""
    if lookahead not in (0, 1):
        raise ValueError(
            f"lookahead={lookahead!r}: the horizon render and its speculative "
            "chain are not ported yet (ROADMAP Queue 1 item 1); use 0"
        )
    if voice_buckets != "off":
        raise ValueError(
            f"voice_buckets={voice_buckets!r}: bucketed prefix rendering is "
            "not ported yet (ROADMAP Queue 1 item 2); use 'off'"
        )
    if ratio_ladder != "off":
        raise ValueError(
            f"ratio_ladder={ratio_ladder!r}: the ratio ladder is not ported "
            "yet (ROADMAP Queue 1 item 3); use 'off'"
        )
    if mesh is not None:
        raise ValueError(
            "mesh: voice sharding over torch.distributed is not ported yet "
            "(ROADMAP Queue 1 item 8)"
        )


class AudioEngine:
    def __init__(
        self,
        device,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        block_frames: int = DEFAULT_BLOCK_FRAMES,
        num_voices: int = DEFAULT_NUM_VOICES,
        voices_per_lane: Optional[int] = None,
        quirk_gain: bool = False,
        fetch: str = "auto",
        host_core: str = "auto",
        bank_dtype: str = "float32",
        max_pitch_ratio: float = 4.0,
        lookahead: "str | int" = 0,
        voice_buckets: str = "off",
        ratio_ladder: str = "off",
        mesh=None,
    ):
        _reject_unported(lookahead, voice_buckets, ratio_ladder, mesh)
        # explicit device: "cuda" without a card raises (device.py)
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.block_frames = block_frames
        self.quirk_gain = quirk_gain
        if fetch == "auto":
            # the windows kernel on the card (quirk_gain needs the taps
            # separately and always renders through gather); the plain
            # gather fetch on the CPU
            fetch = ("windows" if self.device.type == "cuda"
                     and not quirk_gain else "gather")
        if fetch.startswith("windows"):
            # the suffix only steers the TPU kernel's schedule: validate it
            # like the reference, at construction
            parse_suffix(fetch.partition(":")[2])
        elif fetch != "gather":
            raise ValueError(f"fetch must be auto|gather|windows[:...]: "
                             f"{fetch}")
        self.fetch = fetch
        if bank_dtype not in ("float32", "int16"):
            raise ValueError(f"bank_dtype must be float32|int16: {bank_dtype}")
        self.bank_dtype = bank_dtype
        # declared transposition envelope for the WINDOWS fetch: it sizes the
        # fetch regions (and the bank's tail guard). Notes are NOT clamped to
        # it: ratios beyond the envelope dispatch through the gather fetch
        # (reference-unbounded pitchRatio, lib/SamplerSynthVoice.cpp:115-116;
        # see _render_rmax).
        if not 1.0 <= float(max_pitch_ratio) <= 4.0:
            raise ValueError("max_pitch_ratio must be within [1.0, 4.0]")
        self.max_pitch_ratio = float(max_pitch_ratio)
        # native host core (native/zl_hostcore.cpp): one-pass program build +
        # state advance; the numpy path remains the reference implementation
        self.use_native_host = False
        if host_core in ("auto", "native"):
            from libzl_tpu.engine import hostcore as _hostcore

            if _hostcore.available():
                self.use_native_host = True
            elif host_core == "native":
                raise RuntimeError("native host core requested but unavailable")

        self.clock = BlockClock(
            sample_rate=float(sample_rate),
            block_frames=block_frames,
            bpm=float(DEFAULT_BPM),
        )
        self.ring = StepRing()
        self.pool = VoicePool(num_voices, block_frames, float(sample_rate))
        self.allocator = VoiceAllocator(self.pool, voices_per_lane)
        # the region tail guard covers one block's fetch regions
        self.bank = SoundBank(
            tail_guard=region_tail_guard(block_frames, self.max_pitch_ratio)
        )
        self._bank_version_on_device = -1
        self._device_sound_data = None
        self._device_strips = None
        self._host_strips_snapshot = None
        # dispatched non-idle blocks by the fetch they rendered with
        self.fetch_dispatches = {"windows": 0, "gather": 0}

        self.strips = default_strip_params(render_mod.NUM_STRIPS)
        # GlobalPlayback strip gets its wets zeroed (lib/MidiRouter.cpp:876-880)
        self.strips.wet1[0] = 0.0
        self.strips.wet2[0] = 0.0
        self.lane_enabled = np.ones(NUM_SAMPLER_CHANNELS, bool)

        self.clips: dict[int, object] = {}
        self.router = MidiRouter()
        self.transport = TransportManager(self)
        self.sampler_map = SamplerNoteMapper(self)
        # When True (default), Start/StopPlayback timer commands drive the
        # engine transport directly; the reference instead emits
        # pleaseStart/StopPlayback for the UI to act on — callbacks fire
        # either way.
        self.transport_commands_control_engine = True
        self.levels = AudioLevels(self)
        # 50 ms analysis cadence in blocks (lib/AudioLevels.cpp:325)
        self._levels_every = max(
            int(0.05 * sample_rate / block_frames), 1
        )
        self._last_analyze_block = -(10**9)
        # queued per-block peak tensors (see accumulate_peaks)
        self._peak_accum: list = []
        # deferred clip renders completed by the worker thread; deque's
        # atomic append/popleft close the swap-vs-append race
        self._pending_renders: "collections.deque" = collections.deque()
        self._pending_immediate_midi: list = []
        self.transport_running = False
        # per-block time-weighted transport BPM (the quantized blend the
        # reference publishes to the JACK timebase, lib/SyncTimer.cpp:644-673)
        self.period_bpm = float(DEFAULT_BPM)
        # callbacks (SyncTimer signals / C callback registry,
        # lib/SyncTimer.cpp:397-401, libzl.h:74-75)
        self.timer_callbacks: list[Callable[[int], None]] = []
        self.timer_command_callbacks: list[Callable[[TimerCommand], None]] = []
        self.start_playback_callbacks: list[Callable[[], None]] = []
        self.stop_playback_callbacks: list[Callable[[], None]] = []
        self.clip_command_sent_callbacks: list[Callable[[ClipCommand], None]] = []
        self.total_blocks = 0
        # per-stage host wall time (libzl_tpu/utils/profiling): spans
        # process_block, host_program and dispatch (see process_block)
        self.profiler = BlockProfiler()
        # per-block scheduled-vs-delivered event accounting across the MIDI
        # fabric (MidiRouterWatchdog analog, lib/MidiRouter.cpp:135-188)
        self.watchdog = EventWatchdog()

    # ------------------------------------------------------------ clip admin

    @property
    def bpm(self) -> float:
        return self.clock.bpm

    def register_clip(self, clip) -> None:
        """SamplerSynth::registerClip analog: load the clip's playback buffer
        into the sound bank (uploaded to the device at the next block)."""
        clip.slot = self.bank.load(clip.playback_audio)
        self.clips[clip.id] = clip

    def reload_clip_sound(self, clip) -> None:
        """playbackFileChanged analog (lib/SamplerSynthSound.cpp:68)."""
        clip.slot = self.bank.replace(clip.slot.slot, clip.playback_audio)
        # live voices switch to the new render at the next block, like the
        # reference's per-block buffer re-read (SamplerSynthVoice.cpp:189-191)
        self.pool.rebase_clip(clip.id, clip.slot.base, clip.slot.length)

    def unregister_clip(self, clip) -> None:
        if clip.id in self.clips:
            del self.clips[clip.id]
        if clip.slot is not None:
            self.bank.unload(clip.slot.slot)
            clip.slot = None

    # ------------------------------------------------------------ scheduling

    def schedule_clip_command(self, cmd: ClipCommand, delay: int = 0) -> None:
        self.ring.schedule_clip_command(cmd, delay)

    def schedule_timer_command(self, cmd: TimerCommand, delay: int = 0) -> None:
        self.ring.schedule_timer_command(cmd, delay)

    def schedule_midi(self, data: bytes, delay: int = 0) -> None:
        self.ring.schedule_midi(data, delay)

    def schedule_note(
        self,
        midi_note: int,
        midi_channel: int,
        set_on: bool = True,
        velocity: int = 64,
        duration: int = 0,
        delay: int = 0,
    ) -> None:
        """Schedule a MIDI note with an optional automatic off `duration`
        ticks later (SyncTimer::scheduleNote, lib/SyncTimer.cpp:1069-1087;
        the off velocity is 64 like the reference)."""
        status = (0x90 if set_on else 0x80) | (midi_channel & 0x0F)
        self.ring.schedule_midi(
            bytes([status, midi_note & 0x7F, velocity & 0x7F]), delay
        )
        if set_on and duration > 0:
            self.schedule_note(
                midi_note, midi_channel, False, 64, 0, delay + duration
            )

    def send_note_immediately(self, midi_note: int, midi_channel: int,
                              set_on: bool = True, velocity: int = 64) -> None:
        """SyncTimer::sendNoteImmediately (lib/SyncTimer.cpp:1096-1105)."""
        self.schedule_note(midi_note, midi_channel, set_on, velocity, 0, 0)

    def queue_clip_to_start(self, clip, midi_channel: int = -1) -> None:
        """Schedule a looped start at the next bar boundary
        (lib/SyncTimer.cpp:816-832)."""
        cmd = ClipCommand.channel(clip.id, midi_channel)
        cmd.midi_note = 60
        cmd.change_volume = True
        cmd.volume = 1.0
        # restart the loop rather than layering a second one
        # (lib/SyncTimer.cpp:825-827: stopPlayback AND startPlayback)
        cmd.stop_playback = True
        cmd.start_playback = True
        cmd.looping = True
        cmd.change_looping = True
        delay = (
            0 if not self.transport_running
            else next_bar_delay(self.clock.tick_position)
        )
        self.schedule_clip_command(cmd, delay)

    def queue_clip_to_stop(self, clip, midi_channel: int = -1) -> None:
        cmd = ClipCommand.channel(clip.id, midi_channel)
        cmd.midi_note = 60
        cmd.stop_playback = True
        delay = (
            0 if not self.transport_running
            else next_bar_delay(self.clock.tick_position)
        )
        self.schedule_clip_command(cmd, delay)

    # ------------------------------------------------------------- transport

    def start_transport(self, bpm: Optional[float] = None) -> None:
        """SyncTimer::start (lib/SyncTimer.cpp:870-879)."""
        if bpm is not None:
            self.set_bpm(bpm)
        self.transport_running = True

    def stop_transport(self) -> None:
        """SyncTimer::stop with the ring flush (lib/SyncTimer.cpp:881-929)."""
        self.transport_running = False
        note_offs, zeroed = self.ring.flush_for_stop()
        for cmd in zeroed:
            self.ring.schedule_clip_command(cmd, 0)
        # extend, don't overwrite: a second stop landing before the next
        # block must not discard the first flush's undelivered note-offs
        self._pending_immediate_midi.extend(ev.data for ev in note_offs)
        # musical position resets (beat/cumulativeBeat/jackPlayhead zeroing)
        self.clock.tick_position = 0
        self.clock.anchor_tick = 0
        self.clock.anchor_sample = float(self.clock.sample_position)

    def set_bpm(self, bpm: float) -> None:
        self.clock.set_bpm(float(np.clip(bpm, BPM_MINIMUM, BPM_MAXIMUM)))

    # output latency in blocks: 1 render block + the pump's pipeline depth
    # (the JACK latency-callback analog, lib/SyncTimer.cpp:726-743)
    output_latency_blocks = 2

    def schedule_ahead_amount(self) -> int:
        """Ticks of schedule-ahead covering the engine's output latency
        (scheduleAheadAmount analog, lib/SyncTimer.cpp:711-715)."""
        latency = (
            self.output_latency_blocks * self.block_frames / self.sample_rate
        )
        return schedule_ahead_ticks(self.bpm, latency)

    def stop_all_clips(self) -> None:
        """stopClips C API analog (lib/libzl.cpp:441-449)."""
        for clip in list(self.clips.values()):
            clip.stop(-3)

    # ---------------------------------------------------------- passthrough

    def strip_index(self, channel: int) -> int:
        """C API channel convention: -1 = GlobalPlayback, 0..9 = channels
        (lib/libzl.cpp:476-575)."""
        if not PASSTHROUGH_CHANNEL_MIN <= channel <= PASSTHROUGH_CHANNEL_MAX:
            raise ValueError(f"passthrough channel out of range: {channel}")
        return channel + 1

    def set_strip(self, channel: int, **kwargs) -> None:
        i = self.strip_index(channel)
        for key, value in kwargs.items():
            getattr(self.strips, key)[i] = value

    def get_strip(self, channel: int, key: str) -> float:
        return float(getattr(self.strips, key)[self.strip_index(channel)])

    # -------------------------------------------------------------- commands

    def _apply_timer_command(self, cmd: TimerCommand, tick: int,
                             frame_offset: int) -> None:
        """lib/SyncTimer.cpp:563-632."""
        for cb in self.timer_command_callbacks:
            cb(cmd)
        op = cmd.operation
        if op == Operation.START_PLAYBACK:
            for cb in self.start_playback_callbacks:
                cb()
            if self.transport_commands_control_engine:
                self.start_transport()
        elif op == Operation.STOP_PLAYBACK:
            for cb in self.stop_playback_callbacks:
                cb()
            if self.transport_commands_control_engine:
                self.stop_transport()
        elif op in (Operation.CLIP_COMMAND, Operation.START_CLIP_LOOP,
                    Operation.STOP_CLIP_LOOP):
            clip_cmd = cmd.data_parameter
            if isinstance(clip_cmd, ClipCommand):
                self._apply_clip_command(clip_cmd, tick, frame_offset)
        elif op == Operation.SAMPLER_CHANNEL_ENABLED_STATE:
            # out-of-range channels are silently ignored like the
            # reference's guarded switch — a scheduled bad command must not
            # abort the tick walk with the clock half-advanced
            if SAMPLER_CHANNEL_MIN <= cmd.parameter <= SAMPLER_CHANNEL_MAX:
                lane = channel_to_lane(cmd.parameter)
                self.lane_enabled[lane] = cmd.parameter2 != 0
        elif op == Operation.SET_BPM:
            self.set_bpm(cmd.parameter)
        elif op == Operation.PASSTHROUGH_CLIENT:
            self._apply_passthrough_command(cmd)
        elif op in (Operation.REGISTER_CAS, Operation.UNREGISTER_CAS):
            clip = cmd.data_parameter
            if clip is not None:
                if op == Operation.REGISTER_CAS:
                    self.register_clip(clip)
                else:
                    self.unregister_clip(clip)
        # START_PART / STOP_PART / AUTOMATION / INVALID: observer-only,
        # like the reference's default branch

    def _apply_passthrough_command(self, cmd: TimerCommand) -> None:
        """PassthroughClientOperation value conventions
        (lib/TimerCommand.h:25): volumes 0..100, pan -100..100, muted 0/1.
        Out-of-range channels are ignored (the reference's switches
        bounds-check)."""
        if not PASSTHROUGH_CHANNEL_MIN <= cmd.parameter <= PASSTHROUGH_CHANNEL_MAX:
            return
        i = self.strip_index(cmd.parameter)
        setting = cmd.parameter2
        if setting == PASSTHROUGH_SETTING_DRY:
            self.strips.dry[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_WETFX1:
            self.strips.wet1[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_WETFX2:
            self.strips.wet2[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_PAN:
            self.strips.pan[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_MUTED:
            self.strips.muted[i] = 1.0 if cmd.parameter3 else 0.0

    def _apply_clip_command(self, cmd: ClipCommand, tick: int,
                            frame_offset: int) -> None:
        clip = self.clips.get(cmd.clip_id)
        # speed/pitch/gain changes route to the clip's offline render —
        # DEFERRED to the render worker: a whole-clip STFT must not stall
        # the realtime block loop (lib/ClipAudioSource.cpp:404-413)
        if clip is not None:
            if cmd.change_pitch:
                clip.set_pitch(cmd.pitch_change, defer=True)
            if cmd.change_speed and cmd.speed_ratio > 0:
                # a scheduled bad ratio is ignored (a mid-tick-walk raise
                # would abort the block with the clock half-advanced)
                clip.set_speed_ratio(cmd.speed_ratio, defer=True)
            if cmd.change_gain_db:
                clip.set_gain(cmd.gain_db, defer=True)
        self.allocator.handle(cmd, clip, tick, frame_offset)
        for cb in self.clip_command_sent_callbacks:
            cb(cmd)

    # ------------------------------------------------------------- rendering

    def _render_rmax(self, prog_i, prog_f) -> Optional[float]:
        """The fetch envelope this block renders at: `max_pitch_ratio`, or
        None when some active voice's pitch ratio exceeds it — the dispatch
        then routes through the region-free GATHER fetch, which supports the
        reference's unbounded pitchRatio (lib/SamplerSynthVoice.cpp:115-116).
        Gather engines never fall back (any ratio is in range for a clamped
        gather)."""
        if not self.fetch.startswith("windows"):
            return self.max_pitch_ratio
        act = prog_i[:, _INT_SCALARS.index("active")] != 0
        if not act.any():
            return self.max_pitch_ratio
        ratio = (prog_i[:, _INT_SCALARS.index("rate_int")]
                 + prog_f[:, _F32_SCALARS.index("rate_frac")])
        m = float(np.max(np.where(act, ratio, 0.0)))
        return self.max_pitch_ratio if m <= self.max_pitch_ratio else None

    def _dispatch_packed(self, sound, prog_i, prog_f, strips_packed):
        # ONE host->device buffer per block: the program pair fuses into a
        # single int32 matrix (f32 columns bit-cast), uploaded from pinned
        # memory on CUDA so the host runs ahead of the card
        fused = convert.program_tensor(prog_i, prog_f, self.device)
        fetch = self.fetch
        rmax = self._render_rmax(prog_i, prog_f)
        if rmax is None:
            # over-envelope pitch (the reference's unbounded pitchRatio)
            fetch, rmax = "gather", self.max_pitch_ratio
        kind = "gather" if self.quirk_gain else fetch.partition(":")[0]
        self.fetch_dispatches[kind] += 1
        return render_mod.render_block_fused(
            sound, fused, strips_packed,
            block_frames=self.block_frames, quirk_gain=self.quirk_gain,
            fetch=fetch, max_pitch_ratio=rmax,
        )

    def _release_died(self, died_pairs) -> None:
        """Dead voices release their playback positions
        (lib/SamplerSynthVoice.cpp:156-158)."""
        for cid, pid in died_pairs:
            clip = self.clips.get(int(cid))
            if clip is not None:
                clip.positions_model.remove_position(int(pid))

    def _zero_outputs(self) -> render_mod.RenderOutputs:
        if not hasattr(self, "_zero_outputs_cache"):
            B = self.block_frames

            def z(*shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)

            self._zero_outputs_cache = render_mod.RenderOutputs(
                master=z(B, 2),
                lane_mix=z(NUM_SAMPLER_CHANNELS, B, 2),
                strip_dry=z(render_mod.NUM_STRIPS, B, 2),
                strip_wet1=z(render_mod.NUM_STRIPS, B, 2),
                strip_wet2=z(render_mod.NUM_STRIPS, B, 2),
                lane_peaks=z(NUM_SAMPLER_CHANNELS, 2),
                lane_rms=z(NUM_SAMPLER_CHANNELS, 2),
                master_peak=z(2),
                voice_peaks=z(self.pool.num_voices),
            )
        return self._zero_outputs_cache

    def _sound_data_for_backend(self):
        """The sound bank as a device tensor, re-uploaded only when
        `bank.version` changes: planar [2, N] for the windows fetch (its
        regions are runs along the sample axis), interleaved [N, 2] for the
        gather fetch (one row index reads the stereo pair). An int16 bank
        stays int16 on the device and dequantizes at the fetch."""
        if self._bank_version_on_device != self.bank.version:
            self._check_bank_capacity()
            layout = ("planar" if self.fetch.startswith("windows")
                      else "interleaved")
            self._device_sound_data = None  # free the old copy first
            self._device_sound_data = convert.sound_bank_tensor(
                self.bank.data, self.device, self.bank_dtype, layout)
            self._bank_version_on_device = self.bank.version
        return self._device_sound_data

    def _check_bank_capacity(self) -> None:
        """The bank must fit the card beside the render's working set: fail
        loudly at upload time instead of running out of memory
        mid-performance."""
        if self.device.type != "cuda":
            return
        itemsize = 2 if self.bank_dtype == "int16" else 4
        bank_bytes = self.bank.data.size * itemsize
        _, total = torch.cuda.mem_get_info(self.device)
        if bank_bytes > 0.6 * total:
            raise RuntimeError(
                f"sound bank ({bank_bytes / 2**30:.2f} GiB) exceeds 60% of "
                f"device memory ({total / 2**30:.2f} GiB). Use "
                f"bank_dtype='int16' (half the bytes), unload idle clips, or "
                f"split the session across engines."
            )

    def _packed_strips_for_backend(self):
        """Strips change rarely (UI gestures): keep a device copy and
        re-upload only when the packed values change."""
        packed = pack_strips(self.strips)
        if self._host_strips_snapshot is None or not np.array_equal(
            packed, self._host_strips_snapshot
        ):
            self._device_strips = convert.strips_tensor(self.strips,
                                                        self.device)
            self._host_strips_snapshot = packed
        return self._device_strips

    def warmup(self) -> None:
        """Build the CUDA kernel (windows fetch on the card) and render one
        block of the current pool state, without advancing it, ending in one
        real device->host transfer — so the first live block pays neither
        the nvcc build nor first-launch costs."""
        if self.device.type == "cuda" and self.fetch.startswith("windows"):
            from .. import _build

            _build.load()
        prog = self.pool.build_program(
            block_start_sample=float(self.clock.sample_position),
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick,
            lane_enabled=self.lane_enabled,
        )
        prog_i, prog_f = pack_program(prog)
        out = render_mod.render_block_fused(
            self._sound_data_for_backend(),
            convert.program_tensor(prog_i, prog_f, self.device),
            self._packed_strips_for_backend(),
            block_frames=self.block_frames, quirk_gain=self.quirk_gain,
            fetch=self.fetch, max_pitch_ratio=self.max_pitch_ratio,
        )
        out.master.cpu()

    def process_block(self) -> BlockResult:
        """Render one block: drain due ticks, dispatch, advance."""
        _t0 = time.perf_counter()
        # swap in any completed deferred clip renders (the worker appends;
        # deque.popleft is atomic so no append can be lost to a list swap)
        while True:
            try:
                fn = self._pending_renders.popleft()
            except IndexError:
                break
            fn()
        midi_out: list[tuple[int, bytes]] = []
        if self._pending_immediate_midi:
            midi_out.extend((0, data) for data in self._pending_immediate_midi)
            self._pending_immediate_midi = []

        # Dynamic tick walk: tick spacing re-derives after every tick's
        # commands, so a SetBpm firing mid-block changes the spacing of the
        # REMAINING ticks in the same block (lib/SyncTimer.cpp:636-641). The
        # per-block transport BPM is the time-weighted blend of the per-tick
        # BPMs, rounded to 2 decimals (lib/SyncTimer.cpp:644,672-673).
        block_start = float(self.clock.sample_position)
        block_end = block_start + self.block_frames
        tick_count = 0
        bpm_blend = 0.0
        seg_start = block_start
        t = self.clock.tick_position
        guard = 0
        while True:
            ts = self.clock.tick_time_samples(t)
            if ts >= block_end:
                break
            guard += 1
            if guard > 8 * self.block_frames:
                raise RuntimeError("tick walk diverged (bpm below floor?)")
            offset = max(int(ts - block_start), 0)
            # the blend segment leading up to this tick runs at the BPM set
            # by the previous tick's commands
            seg_end = min(max(ts, block_start), block_end)
            bpm_blend += self.clock.bpm * (seg_end - seg_start)
            seg_start = seg_end
            # expose the firing tick so set_bpm re-anchors exactly here
            self.clock.tick_position = t
            if self.transport_running:
                # sequencer schedule-ahead hook (lib/SyncTimer.cpp:397-401)
                for cb in self.timer_callbacks:
                    cb(t)
                if midi_clock_due(t):
                    midi_out.append((offset, bytes([MIDI_BEAT_CLOCK_BYTE])))
            step = self.ring.pop_next()
            for ev in step.midi:
                midi_out.append((offset, ev.data))
            for ccmd in step.clip_commands:
                self._apply_clip_command(ccmd, t, offset)
            for tcmd in step.timer_commands:
                self._apply_timer_command(tcmd, t, offset)
            tick_count += 1
            if self.clock.tick_position != t:
                # a transport reset (stop flush) re-based the musical clock;
                # resume the walk from the new position
                t = self.clock.tick_position
            else:
                t += 1
        self.clock.tick_position = t
        bpm_blend += self.clock.bpm * (block_end - seg_start)
        self.period_bpm = (
            round(bpm_blend / self.block_frames * 100.0) / 100.0
        )

        # MIDI routing fabric: transport ticks, internal + hardware routing,
        # transport control, note->sampler mapping (all sample-offset aware)
        self.transport.emit_ticks(
            self.clock.sample_position, self.block_frames, midi_out
        )
        self.router.begin_block()
        self.router.route_internal(midi_out)
        self.router.route_hardware()
        self.transport.handle_passthrough(self.router.passthrough_out)
        self.sampler_map.handle(self.router, self.router.passthrough_out)
        self.router.flush_external()
        # event watchdog: everything that entered the fabric this block must
        # have reached a terminal (sink append or intentional swallow)
        self.watchdog.observe_block(
            self.router.in_count, self.router.accounted_count
        )

        # idle shortcut: with no live voices the render is identically zero —
        # skip the device dispatch
        if not self.pool.active.any():
            self.clock.advance_block()
            self.total_blocks += 1
            self.profiler.record("process_block", time.perf_counter() - _t0)
            return BlockResult(
                outputs=self._zero_outputs(), midi_out=midi_out,
                tick_count=tick_count,
            )

        clock_args = dict(
            block_start_sample=float(self.clock.sample_position),
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick,
        )
        sound = self._sound_data_for_backend()
        strips = self._packed_strips_for_backend()
        # per-layer spans: "host_program" is the program build (+ the native
        # core's fused advance), "dispatch" the upload + render enqueue (on
        # CUDA the host returns before the card finishes)
        if self.use_native_host:
            from libzl_tpu.engine import hostcore as _hostcore

            with self.profiler.span("host_program"):
                prog_i, prog_f, died_info = _hostcore.voice_update(
                    self.pool, lane_enabled=self.lane_enabled, **clock_args
                )
            with self.profiler.span("dispatch"):
                outputs = self._dispatch_packed(sound, prog_i, prog_f, strips)
            died_pairs = [(cid, pid) for _, cid, pid in died_info]
        else:
            with self.profiler.span("host_program"):
                prog = self.pool.build_program(
                    lane_enabled=self.lane_enabled, **clock_args
                )
                prog_i, prog_f = pack_program(prog)
            with self.profiler.span("dispatch"):
                outputs = self._dispatch_packed(sound, prog_i, prog_f, strips)
            adv = self.pool.advance(prog)
            died_pairs = list(zip(adv["died_clips"], adv["died_positions"]))
        self._release_died(died_pairs)
        self.clock.advance_block()
        self.total_blocks += 1
        self.profiler.record("process_block", time.perf_counter() - _t0)
        return BlockResult(outputs=outputs, midi_out=midi_out,
                           tick_count=tick_count)

    # ------------------------------------------------------- session updates

    def accumulate_peaks(self, result: BlockResult) -> None:
        """Queue one block's peak tensors for the next update_session
        WITHOUT any device->host transfer; the queued tensors ride the next
        session fetch raw and are max-folded host-side (session_fetch_plan).
        A realtime pump calls this every block so transients between
        analysis points are not lost (lib/AudioLevels.cpp:238-257,
        347-412)."""
        o = result.outputs
        self._peak_accum.append((o.lane_peaks, o.master_peak))

    def session_fetch_plan(self, result: BlockResult):
        """Session tensors + an unpacker, so a caller can append them to its
        own tensors and make ONE combined device->host copy. Returns
        ``(tensors, unpack, total)`` where ``unpack(flat, off)`` slices the
        flattened host copy back into the fetch_session_arrays dict and
        ``total`` is the element count consumed. Drains the peak queue (the
        max-fold happens host-side in numpy). Build plans in block order."""
        o = result.outputs
        pairs = self._peak_accum
        self._peak_accum = []
        arrs = []
        for lp, mp in pairs:
            arrs += [lp, mp]
        arrs += [o.lane_peaks, o.master_peak, o.lane_rms, o.voice_peaks]
        lp_shape = tuple(o.lane_peaks.shape)
        mp_shape = tuple(o.master_peak.shape)
        rms_shape = tuple(o.lane_rms.shape)
        vp_shape = tuple(o.voice_peaks.shape)
        n_lp = int(np.prod(lp_shape))
        n_mp = int(np.prod(mp_shape))
        n_rms = int(np.prod(rms_shape))
        n_vp = int(np.prod(vp_shape))
        nq = len(pairs)

        def unpack(flat, off=0):
            lanes = mast = None
            for _ in range(nq + 1):
                lp = np.asarray(flat[off:off + n_lp]).reshape(lp_shape)
                off += n_lp
                mp = np.asarray(flat[off:off + n_mp]).reshape(mp_shape)
                off += n_mp
                lanes = lp if lanes is None else np.maximum(lanes, lp)
                mast = mp if mast is None else np.maximum(mast, mp)
            rms = np.asarray(flat[off:off + n_rms]).reshape(rms_shape)
            off += n_rms
            vp = np.asarray(flat[off:off + n_vp]).reshape(vp_shape)
            return dict(lane_peaks=lanes, master_peak=mast,
                        lane_rms=rms, voice_peaks=vp)

        total = (nq + 1) * (n_lp + n_mp) + n_rms + n_vp
        return arrs, unpack, total

    def fetch_session_arrays(self, result: BlockResult) -> dict:
        """Fetch everything update_session needs in ONE device->host copy
        (folded peaks, RMS, voice peaks)."""
        arrs, unpack, _ = self.session_fetch_plan(result)
        flat = torch.cat([a.reshape(-1) for a in arrs]).cpu().numpy()
        return unpack(flat)

    def update_session(self, result: BlockResult,
                       include_recorders: bool = True,
                       fetched: Optional[dict] = None) -> None:
        """Feed voice peaks/progress back to the clip positions models
        (lib/SamplerSynthVoice.cpp:264-267), the AudioLevels meters and any
        active disk recorders. Forces ONE device->host copy of the block's
        meter and peak tensors (fetch_session_arrays) unless the caller
        passes `fetched`; meters only need the reference's 50 ms cadence
        (lib/AudioLevels.cpp:325)."""
        if fetched is None:
            fetched = self.fetch_session_arrays(result)
        self.levels.ingest_block(
            result.outputs,
            peak_override=(fetched["lane_peaks"], fetched["master_peak"]),
            rms_override=fetched["lane_rms"],
        )
        # analysis cadence by block distance (not modulo: callers invoke this
        # at different block phases)
        if self.total_blocks - self._last_analyze_block >= self._levels_every:
            self.levels.analyze()
            self._last_analyze_block = self.total_blocks
        if include_recorders and self.levels.is_recording:
            self.levels.feed_recorders(render_mod.RenderOutputs(
                *(t.cpu().numpy() for t in result.outputs)))
        peaks = fetched["voice_peaks"]
        progress = self.pool.progress()
        act = np.flatnonzero(self.pool.active)
        if act.size:
            # group voices by clip and push one batched update per clip
            # (row-by-row set_gain_and_progress is O(voices * positions))
            clip_ids = self.pool.clip_id[act]
            order = np.argsort(clip_ids, kind="stable")
            sorted_cids = clip_ids[order]
            pids = self.pool.position_id[act][order].tolist()
            gains = (peaks[act][order] * 0.5).tolist()
            progs = progress[act][order].tolist()
            starts = np.concatenate(
                [[0], np.flatnonzero(np.diff(sorted_cids)) + 1,
                 [act.size]]
            )
            for i in range(len(starts) - 1):
                lo, hi = int(starts[i]), int(starts[i + 1])
                clip = self.clips.get(int(sorted_cids[lo]))
                if clip is None:
                    continue
                clip.positions_model.set_many(
                    pids[lo:hi], gains[lo:hi], progs[lo:hi]
                )
        for clip in self.clips.values():
            clip.positions_model.cleanup()
            clip.sync_progress()
            clip.sync_audio_level()
