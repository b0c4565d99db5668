"""AudioEngine on PyTorch: the host block runtime with a torch device seam.

A fork of libzl_tpu/engine/engine.py, not a subclass: the reference engine
imports engine/render.py when it is loaded, and that module wraps every entry
point in `jax.jit`, so importing (let alone subclassing) the reference engine
loads JAX — which this package must never do. The fork keeps the reference's
host half as it is (clip admin, scheduling, transport, strips, the timer and
clip command handlers, the tick walk and MIDI fabric of process_block, the
session updates), on the port's own copies of the host modules, and replaces
the device seam: the sound bank and strips as device tensors, one fused
program upload per block (per shard), and the render through
`parallel/sharding.render_block_sharded`.

    BlockClock (musical time)      StepRing (scheduled events)
          │                              │
          └──> process_block(): drain due ticks -> commands -> VoicePool
                    │
                    ├─ lookahead horizon: emit a pre-rendered slice, or
                    │   sim H blocks + ONE upload -> render_horizon_sharded
                    │   (speculative chain on two worker threads renders
                    │   the next horizon while this one is emitted)
                    ├─ per-block: native host core / VoicePool.build_program
                    │   (fused program [V, K], one upload) -> render (torch)
                    └─ session updates (positions, meters) <────────────┘

The reference's defaults are the port's: the lookahead horizon ("auto": H=16
at B=128, H=2 at B=1024), bucketed prefix rendering and the ratio ladder.
`mesh` (parallel/sharding.make_mesh) shards the voice axis over the mesh's
devices from this one process, as the reference's single controller does:
every per-block and horizon dispatch renders each shard's voices on its own
device and sums the lane mixes on the first, which is the engine's device.
Without a mesh the engine's one device is the mesh: one shard, the same
dispatch.

Two of the reference's faults are not carried over: the speculation depth
(LIBZL_TPU_SPEC_DEPTH) is parsed at engine construction and a bad value
raises, and the `slo_worst` context ring ranks misses by overrun (busy time
minus budget), not by busy time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import queue
import threading
import time
import traceback
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .. import _native, convert
from ..constants import (
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
from ..device import resolve_device
from ..midi.router import MidiRouter
from ..midi.transport import TransportManager
from ..models.audio_levels import AudioLevels
from ..models.sampler_map import SamplerNoteMapper
from ..ops import voice as host_voice
from ..ops.fetch_windows import parse_suffix
from ..ops.mixer import default_strip_params
from ..ops.voice import (
    _F32_SCALARS,
    _INT_SCALARS,
    active_high_water,
    fuse_packed,
    horizon_dyn_cols,
    pack_program,
    pack_strips,
)
from ..parallel import sharding
from ..timebase import BlockClock, next_bar_delay, schedule_ahead_ticks
from ..utils.profiling import (
    BlockProfiler,
    DspLoad,
    EventWatchdog,
    SloCounter,
)
from . import hostcore as _hostcore
from . import render as render_mod
from .allocator import VoiceAllocator
from .commands import (
    PASSTHROUGH_SETTING_DRY,
    PASSTHROUGH_SETTING_MUTED,
    PASSTHROUGH_SETTING_PAN,
    PASSTHROUGH_SETTING_WETFX1,
    PASSTHROUGH_SETTING_WETFX2,
    ClipCommand,
    Operation,
    TimerCommand,
)
from .scheduler import StepRing, midi_clock_due
from .soundbank import SoundBank, region_tail_guard
from .voicestate import VoicePool

SPEC_DEPTH_ENV = "LIBZL_TPU_SPEC_DEPTH"
DEFAULT_SPEC_DEPTH = 2


def spec_depth_from_env() -> int:
    """The speculative chain's depth: LIBZL_TPU_SPEC_DEPTH, a positive
    integer (default 2). A bad value raises, naming the variable."""
    raw = os.environ.get(SPEC_DEPTH_ENV, "").strip()
    if not raw:
        return DEFAULT_SPEC_DEPTH
    try:
        depth = int(raw)
    except ValueError:
        depth = 0
    if depth < 1:
        raise ValueError(
            f"{SPEC_DEPTH_ENV}={raw!r}: the speculative horizon depth must "
            f"be a positive integer"
        )
    return depth


# lazily created process-wide workers for speculative horizons: one
# dispatch thread (uploads and render enqueues) and one sim thread (host
# voice sims), split so consecutive horizon dispatches run back to back
# while the next sim overlaps them (AudioEngine._spec_executor /
# _spec_sim_executor)
_SPEC_EXECUTOR = None
_SPEC_SIM_EXECUTOR = None
_EXECUTORS_LOCK = threading.Lock()


def _nice_spec_worker() -> None:
    """De-prioritize the calling spec-worker thread (Linux: setpriority with
    who=0 is per thread): chain sims and dispatches have a whole-horizon
    deadline, the engine thread's emits a one-block one. No-op where
    unsupported."""
    import sys

    if not sys.platform.startswith("linux"):
        return
    try:
        os.setpriority(os.PRIO_PROCESS, 0, 10)
    except (PermissionError, OSError, AttributeError):
        pass


class _SpecChain:
    """A worker-side speculative horizon chain (AudioEngine._maybe_build_spec).

    The sim thread advances a private spec pool horizon after horizon — no
    re-sync between links: horizon N+1's end state is the pool state after
    its sim — and hands each link's dispatch closure to the dispatch
    thread, so consecutive horizon dispatches run back to back while the
    next sim overlaps them. At most `depth` links are un-adopted; every step
    re-checks the owning engine's spec generation and ends itself
    (releasing its pool) when an event discards the speculation."""

    def __init__(self, eng, gen, end_snap, start, lane, anchor,
                 sound, strips, depth: int):
        self.eng = eng
        self.gen = gen
        self.end_snap = end_snap
        self.start = float(start)
        self.lane = lane
        self.anchor = anchor
        self.sound = sound
        self.strips = strips
        self.depth = depth
        self.pool = None
        self.dead = False
        self.entries: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._outstanding = 0

    def _depth_now(self) -> int:
        """Speculation depth: fixed at `depth`. The reference measured an
        adaptive depth-1-near-events variant worse in event storms (a
        depth-1 chain refills only at adoption), and the generation guards
        already make deep chains cheap to discard."""
        return self.depth

    def launch(self) -> None:
        self.eng._spec_sim_executor().submit(self._step)

    def advance(self) -> None:
        """One link was adopted: refill the speculation depth."""
        with self._lock:
            self._outstanding -= 1
        self.eng._spec_sim_executor().submit(self._step)

    def kill(self) -> None:
        """End regardless of generation (adoption-time mismatch): the next
        step sees `dead` and releases the pool."""
        self.dead = True
        self.eng._spec_sim_executor().submit(self._step)

    def _finish(self) -> None:
        self.dead = True
        if self.pool is not None:
            self.eng._spec_pools.append(self.pool)
            self.pool = None

    def _step(self) -> None:
        # sim-thread body; serialized by the single-thread executor
        try:
            eng = self.eng
            if self.dead or eng._spec_gen != self.gen:
                # an event discarded this speculation while it sat in the
                # worker queue: stop before spending sim or dispatch time
                self._finish()
                return
            with self._lock:
                if self._outstanding >= self._depth_now():
                    return  # paused; adoption re-submits via advance()
            if self.pool is None:
                self.pool = eng._spec_pool_acquire()
                self.pool.sync_from(eng.pool)
                self.pool.restore_state(self.end_snap)
            bundle = eng._sim_horizon_bundle(
                self.start, pool=self.pool, lane=self.lane,
                anchor=self.anchor, sound=self.sound, strips=self.strips,
            )
            if bundle is None:
                # unencodable program: adoption falls back to a fresh
                # synchronous horizon
                self.entries.put(None)
                self._finish()
                return
            dispatch, snaps, died_lists = bundle
            if eng._spec_gen != self.gen:
                self._finish()
                return

            def guarded_dispatch():
                # a killed chain's queued dispatches must not hold up the
                # dispatch thread for the real ones behind them
                if self.dead or eng._spec_gen != self.gen:
                    return None
                return dispatch()

            fut = eng._spec_executor().submit(guarded_dispatch)
            self.entries.put((fut, snaps, died_lists, self.start))
            if not snaps[-1]["active"].any():
                # the whole pool dies within this link: the successor is
                # silence, which the idle shortcut delivers without a
                # dispatch — end the chain after delivering the tail
                self._finish()
                return
            self.start += len(snaps) * eng.block_frames
            with self._lock:
                self._outstanding += 1
                go = self._outstanding < self._depth_now()
            if go:
                eng._spec_sim_executor().submit(self._step)
        except Exception as exc:
            # a failed speculative sim must never take down the audio
            # path: count it, keep it, and let the consumer fall back to a
            # synchronous horizon
            self.eng._note_spec_failure(exc)
            self.entries.put(None)
            self._finish()


@dataclasses.dataclass
class BlockResult:
    """Host-visible outputs of one processed block."""

    outputs: render_mod.RenderOutputs   # tensors on the engine's device
    midi_out: list                      # [(frame_offset, bytes), ...]
    tick_count: int


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
        lookahead: "str | int" = "auto",
        voice_buckets: str = "auto",
        ratio_ladder: str = "auto",
        mesh=None,
    ):
        if voice_buckets not in ("auto", "off"):
            raise ValueError("voice_buckets must be 'auto' or 'off'")
        if ratio_ladder not in ("auto", "off"):
            raise ValueError("ratio_ladder must be auto|off")
        # the speculative chain's depth, checked here and not mid-session
        self._spec_depth = spec_depth_from_env()
        # explicit device: "cuda" without a card raises (device.py)
        self.device = resolve_device(device)
        # the voice axis shards over the mesh (default: the engine's one
        # device); the engine's device is the mesh's first, where the lane
        # mixes are summed and the strip/meter tail runs (parallel/sharding.py)
        if mesh is None:
            mesh = sharding.Mesh((sharding.canonical_device(self.device),))
        else:
            if not isinstance(mesh, sharding.Mesh):
                raise ValueError(
                    f"mesh must be a libzl_tpu_torch.parallel.sharding.Mesh "
                    f"(make_mesh), got {type(mesh).__name__}")
            if num_voices % mesh.size != 0:
                raise ValueError(
                    f"num_voices ({num_voices}) must divide evenly over the "
                    f"{mesh.size}-device mesh")
            if sharding.canonical_device(self.device) != mesh.devices[0]:
                raise ValueError(
                    f"device {str(device)!r} is not the mesh's first device "
                    f"{mesh.devices[0]}: the engine's outputs live there")
        self.mesh = mesh
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
        # Ratio ladder: when every active voice's pitch ratio fits a lower
        # rung, the windows fetch renders with that rung's narrower regions
        # (region_rows(B, rung)): the same taps, so the same output. On the
        # TPU the rung narrowed the kernel's weight slab; the CUDA kernel
        # has no slab, and chip_smoke.py times it at both rungs.
        self._ratio_ladder = [self.max_pitch_ratio]
        if (ratio_ladder == "auto" and fetch.startswith("windows")
                and self.max_pitch_ratio > 2.0):
            self._ratio_ladder = [2.0, self.max_pitch_ratio]
        # native host core (native/zl_hostcore.cpp): one-pass program build +
        # state advance; the numpy path remains the reference implementation
        self.use_native_host = False
        if host_core in ("auto", "native"):
            if _hostcore.available():
                self.use_native_host = True
            elif host_core == "native":
                raise RuntimeError(
                    f"native host core requested but unavailable: "
                    f"{_native.failure('zl_hostcore')}")
            else:
                warnings.warn(
                    f"native host core unavailable, using the numpy program "
                    f"builder: {_native.failure('zl_hostcore')}",
                    RuntimeWarning, stacklevel=2)

        # Speculative lookahead horizon: render H blocks from ONE upload and
        # emit them as per-block slices, preempting the horizon whenever an
        # event lands (note latency stays one block). The horizon is H
        # per-block programs built by simulating the host's own per-block
        # advance, so its output is bit-identical to per-block output.
        # "auto" fills a 2048-frame window (the reference's choice, made on
        # the TPU); on the card the horizon moves the render's enqueue from
        # the engine thread to the speculative chain's dispatch thread.
        if lookahead == "auto":
            self._lookahead = (max(min(16, 2048 // block_frames), 0)
                               if block_frames <= 2048 else 0)
        else:
            self._lookahead = max(int(lookahead), 0)
        if self._lookahead == 1:
            self._lookahead = 0  # a 1-block horizon is the per-block path
        self._h_slices: list = []       # pending device outputs
        self._h_snaps: list = []        # pool state AFTER each slice
        self._h_died: list = []         # (clip_id, position_id) per slice
        self._h_cursor = 0
        self._h_fingerprint = None
        self._h_start0 = 0.0
        # speculative NEXT horizon: built and dispatched mid-emission from
        # the current horizon's end snapshot, adopted at exhaustion
        self._h_next = None  # live _SpecChain, or None
        self._h_next_start = 0.0
        # dedicated pools for worker-side speculative sims (never the live
        # pool off the engine thread); free list, see _spec_pool_acquire
        self._spec_pools: list = []
        # generation counter that cancels orphaned speculative builds
        # (bumped by _discard_horizon, read by the workers)
        self._spec_gen = 0
        self._h_spec_tried = False
        self._spec_built_this_block = False
        self._h_built_this_block = False
        self._adopted_this_block = False
        self._clean_run = 0
        self._block_dirty = False
        # event pacing: blocks since the last event or preemption block
        self._blocks_since_event = 0
        self._oob_preempt = False

        self.clock = BlockClock(
            sample_rate=float(sample_rate),
            block_frames=block_frames,
            bpm=float(DEFAULT_BPM),
        )
        self.ring = StepRing()
        self.pool = VoicePool(num_voices, block_frames, float(sample_rate))
        # Bucketed prefix rendering: the allocator claims the first idle
        # voice (lib/SamplerSynth.cpp:204-215), so live voices cluster at
        # low indices and a sparse session renders the smallest ladder
        # bucket covering the highest active index; voice_peaks pads back
        # to the pool size. Inactive voices contribute nothing. Each bucket
        # splits evenly over the mesh: the ladder's unit is mesh.size * 8, so
        # a sparse session renders a prefix of every shard.
        self._bucket_ladder = None
        if voice_buckets == "auto" and num_voices > 64:
            unit = mesh.size * 8
            ladder = []
            s = ((64 + unit - 1) // unit) * unit
            while s < num_voices:
                ladder.append(s)
                s *= 2
            if ladder:  # at least one size below the full pool
                ladder.append(num_voices)
                self._bucket_ladder = ladder
        self.allocator = VoiceAllocator(self.pool, voices_per_lane)
        # the region tail guard covers one block's fetch regions
        self.bank = SoundBank(
            tail_guard=region_tail_guard(block_frames, self.max_pitch_ratio)
        )
        self._bank_version_on_device = -1
        self._device_sound_data = None
        self._device_strips = None
        self._host_strips_snapshot = None
        # rendered blocks by the fetch they rendered with: per-block
        # dispatches and horizon slices (speculative ones included, whether
        # adopted or discarded). The dispatch thread adds too, under
        # _stats_lock, as it does to the spec failure count.
        self._stats_lock = threading.Lock()
        self.fetch_dispatches = {"windows": 0, "gather": 0}
        # speculative builds or dispatches that raised (the engine then
        # falls back to a synchronous horizon) and the last one's traceback
        self.spec_failures = 0
        self.spec_last_failure: Optional[str] = None

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
        # process_block, host_program and dispatch (per-block path),
        # horizon_build, adopt_wait and emit (lookahead path)
        self.profiler = BlockProfiler()
        # deadline accounting: SLO misses per dispatch kind (emit, horizon,
        # event_rebuild, adopt, spec, per_block, idle) against each kind's
        # budget in block periods, and the smoothed DSP load
        period = block_frames / sample_rate
        self.slo = SloCounter(budget_seconds=period)
        # context of the worst deadline misses (top-N by overrun)
        self._slo_worst: list = []
        self.dsp_load = DspLoad(period_seconds=period)
        self.warmed_graphs = 0
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
        # pool state is about to change: discard any horizon first
        self._mark_event()
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
        self._mark_event()
        if bpm is not None:
            self.set_bpm(bpm)
        self.transport_running = True

    def stop_transport(self) -> None:
        """SyncTimer::stop with the ring flush (lib/SyncTimer.cpp:881-929)."""
        self._mark_event()
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

    def _mark_event(self) -> None:
        """An event is about to mutate engine or pool state: the horizon is
        stale from this block on — discard its remaining slices. The pool
        mirror is already at the emission frontier (emission restores the
        per-slice snapshot), so the command applies to current state."""
        self._block_dirty = True
        if self._h_slices:
            self._discard_horizon()

    def _discard_horizon(self) -> None:
        self._h_slices = []
        self._h_snaps = []
        self._h_died = []
        self._h_cursor = 0
        if self._h_next is not None:
            # explicit kill so a depth-paused chain (no step pending) still
            # runs one last step to return its pool to the free list
            self._h_next.kill()
        self._h_next = None
        self._h_spec_tried = False
        # stale-generation mark: a discarded speculative build still queued
        # or running on a worker exits at its next checkpoint
        self._spec_gen += 1

    def _apply_timer_command(self, cmd: TimerCommand, tick: int,
                             frame_offset: int) -> None:
        """lib/SyncTimer.cpp:563-632."""
        self._mark_event()
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
        self._mark_event()
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

    def _render_bucket(self, prog_i=None) -> Optional[int]:
        """Smallest ladder bucket covering the highest rendering voice, or
        None when bucketing is off. The packed program's own active column
        decides, not pool.active: the native host core has already advanced
        the pool past this block's voice deaths by dispatch time, and a
        dying voice still renders its final frames
        (lib/SamplerSynthVoice.cpp:248-257). Without a program: the pool
        between blocks (a diagnostic for tests)."""
        if self._bucket_ladder is None:
            return None
        if prog_i is None:
            act = np.flatnonzero(self.pool.active)
            hi = int(act[-1]) + 1 if act.size else 0
        else:
            hi = active_high_water(prog_i)
        for s in self._bucket_ladder:
            if s >= hi:
                return s
        return self.pool.num_voices

    # the narrow rung only paid on the TPU for kernels large enough to be
    # stream-bound (the reference's probes): buckets below this size
    # dispatch the top rung only, as the reference does
    RUNG_MIN_SHARD_VOICES = 512

    def _allowed_rungs(self, bucket: Optional[int]) -> list:
        """Rungs warmed and dispatched for this bucket size (judged by its
        per-shard voice count)."""
        v = bucket if bucket is not None else self.pool.num_voices
        if v // self.mesh.size >= self.RUNG_MIN_SHARD_VOICES:
            return self._ratio_ladder
        return self._ratio_ladder[-1:]

    def _render_rmax(self, prog_i, prog_f,
                     rungs: Optional[list] = None) -> Optional[float]:
        """Smallest rung of `rungs` (default: the ladder) covering every
        active voice's pitch ratio this block, or None when some active
        ratio exceeds the declared windows envelope (`max_pitch_ratio`):
        the dispatch then routes through the region-free GATHER fetch,
        which supports the reference's unbounded pitchRatio
        (lib/SamplerSynthVoice.cpp:115-116). Gather engines have one rung
        and never fall back."""
        ladder = rungs if rungs is not None else self._ratio_ladder
        if not self.fetch.startswith("windows"):
            return ladder[0]
        act = prog_i[:, _INT_SCALARS.index("active")] != 0
        if not act.any():
            return ladder[0]
        ratio = (prog_i[:, _INT_SCALARS.index("rate_int")]
                 + prog_f[:, _F32_SCALARS.index("rate_frac")])
        m = float(np.max(np.where(act, ratio, 0.0)))
        for r in ladder:
            if m <= r:
                return r
        return None

    def _fetch_kind(self, fetch: str) -> str:
        return "gather" if self.quirk_gain else fetch.partition(":")[0]

    def _count_fetch(self, kind: str, blocks: int) -> None:
        with self._stats_lock:
            self.fetch_dispatches[kind] += blocks

    def _note_spec_failure(self, exc: BaseException) -> None:
        with self._stats_lock:
            self.spec_failures += 1
            self.spec_last_failure = "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__))

    def _on_device(self):
        """The engine's CUDA device as the calling thread's current device
        (it is per thread: the bridge's drain enters it); a no-op on the
        CPU. The render enters each shard's device itself (sharding._on)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _dispatch_packed(self, sound, prog_i, prog_f, strips_packed):
        bucket = self._render_bucket(prog_i)
        # per-block dispatches in a lookahead engine are event/storm blocks:
        # top rung only, as the reference dispatches them
        rungs = (self._ratio_ladder[-1:] if self._lookahead
                 else self._allowed_rungs(bucket))
        rmax = self._render_rmax(prog_i, prog_f, rungs)
        fetch = self.fetch
        if rmax is None:
            # over-envelope pitch: the region-free gather at full pool
            fetch, rmax, bucket = "gather", self.max_pitch_ratio, None
        V = self.pool.num_voices
        n = V if bucket is None else min(bucket, V)
        self._count_fetch(self._fetch_kind(fetch), 1)
        # ONE host->device buffer per shard and block (its rows of the
        # bucket's prefix of the pool): the program pair fuses into a single
        # int32 matrix (f32 columns bit-cast), uploaded from pinned memory on
        # CUDA so the host runs ahead of the card
        return sharding.render_block_sharded(
            self.mesh, sound, fuse_packed(prog_i[:n], prog_f[:n]),
            strips_packed, block_frames=self.block_frames,
            quirk_gain=self.quirk_gain, fetch=fetch, max_pitch_ratio=rmax,
            pad_voices_to=V,
        )

    # ------------------------------------------------- lookahead horizon

    def _release_died(self, died_pairs) -> None:
        """Dead voices release their playback positions
        (lib/SamplerSynthVoice.cpp:156-158)."""
        for cid, pid in died_pairs:
            clip = self.clips.get(int(cid))
            if clip is not None:
                clip.positions_model.remove_position(int(pid))

    def _fingerprint(self):
        """Out-of-band state a horizon depends on: direct API mutations
        (set_bpm, set_strip, lane toggles, bank reloads) that bypass the
        command hooks must still preempt stale slices."""
        return (
            self.clock.samples_per_tick,
            self.transport_running,
            self.bank.version,
            self.lane_enabled.tobytes(),
            pack_strips(self.strips).tobytes(),
        )

    # an event block rebuilds the horizon in the same dispatch only when the
    # run of clean blocks behind it is at least this long: a storm of
    # back-to-back events degrades to the per-block path
    REBUILD_MIN_GAP = 3

    def _lookahead_outputs(self) -> Optional[render_mod.RenderOutputs]:
        """Emit the next horizon slice, or None when this block dispatches
        per-block (event storm / no live voices).

        Event blocks rebuild the horizon from post-event state in one
        dispatch when recent traffic is sparse (gap >= REBUILD_MIN_GAP);
        quiet sessions start a horizon after 3 consecutive clean blocks.
        Quiet runs pipeline horizons: one block into emission the next
        horizon is built and dispatched from the current one's end snapshot
        on the worker threads (_maybe_build_spec), and adopted at
        exhaustion (_adopt_spec)."""
        if self._block_dirty:
            self._clean_run = 0
            if (self._blocks_since_event >= self.REBUILD_MIN_GAP
                    and self.pool.active.any()):
                return self._start_horizon()
            return None
        if self._h_cursor < len(self._h_slices):
            if self._fingerprint() == self._h_fingerprint:
                self._clean_run += 1
                out = self._emit_slice()
                # the block after the build/adopt block pipelines the next
                # horizon while the remaining slices cover the deadline
                if (self._h_cursor == 2 and self._h_next is None
                        and not self._h_spec_tried):
                    self._maybe_build_spec()
                return out
            # out-of-band mutation: stale slices preempt; rebuild under the
            # same pacing gate
            self._discard_horizon()
            self._clean_run = 0
            self._oob_preempt = True
            if (self._blocks_since_event >= self.REBUILD_MIN_GAP
                    and self.pool.active.any()):
                return self._start_horizon()
            return None
        self._clean_run += 1
        if self._h_next is not None:
            out = self._adopt_spec()
            if out is not None:
                return out
        if self._clean_run < 3 or not self.pool.active.any():
            return None
        return self._start_horizon()

    def _emit_slice(self) -> render_mod.RenderOutputs:
        """Deliver the next pre-rendered slice and bring the pool mirror to
        it (snapshot restore), releasing the positions of voices that died
        in that slice."""
        with self.profiler.span("emit"):
            h = self._h_cursor
            out = self._h_slices[h]
            self.pool.restore_state(self._h_snaps[h])
            self._release_died(self._h_died[h])
            self._h_cursor += 1
        return out

    def _sim_horizon_bundle(self, start0: float, pool=None, lane=None,
                            anchor=None, sound=None, strips=None):
        """Sim H blocks from the CURRENT pool state and prepare ONE compact
        horizon dispatch.

        `pool`/`lane`/`anchor`/`sound`/`strips` default to live engine
        state (the synchronous _start_horizon path); the speculative path
        passes a dedicated spec pool plus inputs resolved on the engine
        thread, so the sim runs on the sim worker without touching the live
        pool. Each slice's program is exactly what per-block dispatch would
        build (the native core's one-call horizon sim, or the numpy
        build+advance loop), shipped as slice 0's fused program plus the
        compact dynamics of slices 1..H-1 (pack_horizon_dynamics).

        Returns (dispatch_closure, snaps, died_lists), or None when a
        program exceeds the compact encoding. Leaves the pool at the
        horizon's END state."""
        H = self._lookahead
        B = self.block_frames
        if pool is None:
            pool = self.pool
        if lane is None:
            # persistent frozen-lane buffer: a stable identity keeps the
            # native host core's pointer cache warm across horizons
            lane = getattr(self, "_h_lane", None)
            if lane is None:
                lane = self._h_lane = np.empty_like(self.lane_enabled)
            lane[:] = self.lane_enabled
        if anchor is None:
            anchor = dict(
                tick_anchor_sample=self.clock.anchor_sample,
                tick_anchor=self.clock.anchor_tick,
                samples_per_tick=self.clock.samples_per_tick,
            )
        if self.use_native_host:
            res = _hostcore.horizon_update(
                pool, slices=H, block_start_sample=start0,
                lane_enabled=lane, **anchor,
            )
            if res is None:
                return None
            prog_i0, prog_f0, dyn, snaps, died_lists = res
        else:
            packed: list = []
            snaps = []
            died_lists = []
            for h in range(H):
                prog = pool.build_program(
                    lane_enabled=lane, block_start_sample=start0 + h * B,
                    **anchor)
                packed.append(pack_program(prog))
                adv = pool.advance(prog)
                died_lists.append(
                    list(zip(adv["died_clips"], adv["died_positions"])))
                snaps.append(pool.save_state())
            dyn = host_voice.pack_horizon_dynamics(packed[1:], pool.istart)
            if dyn is None:
                return None
            prog_i0, prog_f0 = packed[0]
        dispatch = self._horizon_dispatch_closure(
            prog_i0, prog_f0, dyn, sound=sound, strips=strips)
        return dispatch, snaps, died_lists

    def _horizon_dispatch_closure(self, prog_i0, prog_f0, dyn,
                                  sound=None, strips=None):
        """Resolve what a compact-horizon dispatch needs (bucket, rung, the
        one int32 buffer of base program and dynamics) and return a
        zero-argument closure that uploads it and enqueues the H slices'
        render, touching no engine state but the fetch count. The
        speculative path runs the closure on the dispatch worker: each shard
        enters its own device and launches on that thread's current stream
        (the legacy default stream, the engine thread's too)."""
        H = self._lookahead
        B = self.block_frames
        base = fuse_packed(prog_i0, prog_f0)
        K = base.shape[1]
        hz = np.concatenate([base, dyn], axis=1)
        if sound is None:
            sound = self._sound_data_for_backend()
        if strips is None:
            strips = self._packed_strips_for_backend()
        # slice 0 bounds the whole horizon: no events land mid-horizon by
        # construction, so the active high-water and the pitch-ratio
        # envelope can only shrink across slices
        bucket = self._render_bucket(prog_i0)
        rmax = self._render_rmax(prog_i0, prog_f0, self._allowed_rungs(bucket))
        V = self.pool.num_voices
        fetch = self.fetch
        if rmax is None:
            # over-envelope pitch: the region-free gather at full pool
            fetch, rmax, bucket = "gather", self.max_pitch_ratio, None
        if bucket is not None and bucket < V:
            hz = hz[:bucket]
        kind = self._fetch_kind(fetch)
        quirk = self.quirk_gain
        mesh = self.mesh

        def dispatch() -> list:
            outs = sharding.render_horizon_sharded(
                mesh, sound, hz, strips, block_frames=B, slices=H,
                base_cols=K, quirk_gain=quirk, fetch=fetch,
                max_pitch_ratio=rmax, pad_voices_to=V,
            )
            self._count_fetch(kind, H)
            return list(outs)

        return dispatch

    def _start_horizon(self) -> Optional[render_mod.RenderOutputs]:
        """Build + dispatch an H-block horizon from the current frontier and
        emit slice 0. Returns None (pool restored, per-block dispatch takes
        the block) when a program exceeds the compact encoding."""
        with self.profiler.span("horizon_build"):
            snap_pre = self.pool.save_state()
            start0 = float(self.clock.sample_position)
            bundle = self._sim_horizon_bundle(start0)
            if bundle is None:
                self.pool.restore_state(snap_pre)
                return None
            dispatch, snaps, died_lists = bundle
            self._h_slices = dispatch()
        self._h_snaps = snaps
        self._h_died = died_lists
        self._h_cursor = 0
        self._h_start0 = start0
        self._h_fingerprint = self._fingerprint()
        self._h_next = None
        self._h_spec_tried = False
        self._h_built_this_block = True
        return self._emit_slice()

    def _maybe_build_spec(self) -> None:
        """Launch the speculative chain: the NEXT horizons are simmed (sim
        worker, on a dedicated spec pool) and dispatched (dispatch worker)
        from the current horizon's END snapshot while this one's slices are
        emitted, so at exhaustion the next slices are already rendered. Any
        event or out-of-band mutation discards the speculation with the
        horizon (_discard_horizon); one attempt per horizon
        (_h_spec_tried). The engine thread pays only input resolution and a
        submit here."""
        self._h_spec_tried = True
        end_snap = self._h_snaps[-1]
        if not end_snap["active"].any():
            # the whole pool dies within the current horizon: the successor
            # is silence, which the idle shortcut delivers without a dispatch
            return
        start_next = self._h_start0 + len(self._h_slices) * self.block_frames
        # inputs an event could mutate under the worker are resolved HERE
        lane = getattr(self, "_spec_lane", None)
        if lane is None or lane.shape != self.lane_enabled.shape:
            lane = self._spec_lane = np.empty_like(self.lane_enabled)
        lane[:] = self.lane_enabled
        anchor = dict(
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick,
        )
        chain = _SpecChain(
            self, self._spec_gen, end_snap, start_next, lane, anchor,
            self._sound_data_for_backend(),
            self._packed_strips_for_backend(),
            depth=self._spec_depth,
        )
        chain.launch()
        self._h_next = chain
        self._h_next_start = start_next
        self._spec_built_this_block = True

    def _spec_pool_acquire(self):
        """A spec pool matching the live geometry, from the free list or
        fresh (sim worker; pools return to the list only after their sims
        complete, so an in-flight sim never shares its pool)."""
        try:
            pool = self._spec_pools.pop()
        except IndexError:
            pool = None
        live = self.pool
        if (pool is None or pool.num_voices != live.num_voices
                or pool.block_frames != live.block_frames
                or pool.output_rate != live.output_rate):
            pool = VoicePool(live.num_voices, live.block_frames,
                             live.output_rate)
        return pool

    def _adopt_spec(self) -> Optional[render_mod.RenderOutputs]:
        """Install the next speculative horizon at exhaustion and emit its
        slice 0 — valid only when nothing the speculation assumed has
        changed (the fingerprint matches and the clock is exactly at the
        speculated start). On success the chain refills its depth; any
        mismatch or failure kills the chain and falls back to a fresh
        synchronous horizon. A speculative build or dispatch that raised
        counts in `spec_failures` (the reference falls back silently)."""
        chain = self._h_next
        if (self._fingerprint() != self._h_fingerprint
                or float(self.clock.sample_position) != self._h_next_start):
            chain.kill()
            self._h_next = None
            return None
        if chain.dead and chain.entries.empty():
            # ended chain (all voices died in its last link, or a stale
            # generation): nothing more is coming
            self._h_next = None
            return None
        with self.profiler.span("adopt_wait"):
            try:
                # the sim thread is at most one link behind; the timeout is
                # a belt against a wedged worker — fall back, never hang
                entry = chain.entries.get(timeout=60.0)
            except queue.Empty:
                self._note_spec_failure(TimeoutError(
                    "speculative horizon: no chain entry within 60 s"))
                chain.kill()
                self._h_next = None
                return None
            if entry is None:
                # unencodable program mid-chain (or a failed sim, counted
                # by the chain): fall back to a fresh synchronous horizon
                self._h_next = None
                return None
            fut, snaps, died_lists, start = entry
            try:
                slices = fut.result()
            except Exception as exc:
                self._note_spec_failure(exc)
                chain.kill()
                self._h_next = None
                return None
        if slices is None or float(start) != self._h_next_start:
            # the guarded dispatch skipped (the chain raced a kill), or the
            # link does not start here
            chain.kill()
            self._h_next = None
            return None
        chain.advance()
        self._adopted_this_block = True
        self._h_slices = slices
        self._h_snaps = snaps
        self._h_died = died_lists
        self._h_cursor = 0
        self._h_start0 = float(start)
        # the chain stays installed as the speculation for the horizon just
        # adopted (its next link is already simming or dispatching)
        self._h_next_start = float(start) + len(slices) * self.block_frames
        self._h_spec_tried = True
        return self._emit_slice()

    def drain_speculation(self) -> None:
        """Discard the horizon and its speculative chain, then wait until
        both spec workers are idle: afterwards every render this engine
        started has been enqueued (and counted in fetch_dispatches), and no
        worker touches the engine. The next block starts afresh."""
        self._discard_horizon()
        if self._lookahead:
            # sim first: a running step may still hand a dispatch over
            self._spec_sim_executor().submit(lambda: None).result()
            self._spec_executor().submit(lambda: None).result()

    @staticmethod
    def _spec_executor():
        """The process-wide dispatch worker for speculative horizons: one
        thread, shared by every engine in the process."""
        global _SPEC_EXECUTOR
        with _EXECUTORS_LOCK:
            if _SPEC_EXECUTOR is None:
                from concurrent.futures import ThreadPoolExecutor

                _SPEC_EXECUTOR = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="libzl-spec-dispatch",
                    initializer=_nice_spec_worker,
                )
            return _SPEC_EXECUTOR

    @staticmethod
    def _spec_sim_executor():
        """The process-wide sim worker for speculative chains
        (_SpecChain._step). Single-threaded by design: steps of every chain
        serialize, which makes a chain's un-synced pool reuse safe."""
        global _SPEC_SIM_EXECUTOR
        with _EXECUTORS_LOCK:
            if _SPEC_SIM_EXECUTOR is None:
                from concurrent.futures import ThreadPoolExecutor

                _SPEC_SIM_EXECUTOR = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="libzl-spec-sim",
                    initializer=_nice_spec_worker,
                )
            return _SPEC_SIM_EXECUTOR

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
        stays int16 on the device and dequantizes at the fetch. A dict
        {device: tensor}, one copy on each distinct mesh device (any voice
        may fetch any sample)."""
        if self._bank_version_on_device != self.bank.version:
            self._check_bank_capacity()
            layout = ("planar" if self.fetch.startswith("windows")
                      else "interleaved")
            self._device_sound_data = None  # free the old copies first
            self._device_sound_data = {
                dev: convert.sound_bank_tensor(
                    self.bank.data, dev, self.bank_dtype, layout)
                for dev in self.mesh.distinct()
            }
            self._bank_version_on_device = self.bank.version
        return self._device_sound_data

    def _check_bank_capacity(self) -> None:
        """The bank must fit each card that holds it beside the render's
        working set: fail loudly at upload time instead of running out of
        memory mid-performance."""
        itemsize = 2 if self.bank_dtype == "int16" else 4
        bank_bytes = self.bank.data.size * itemsize
        for dev in self.mesh.distinct():
            if dev.type != "cuda":
                continue
            _, total = torch.cuda.mem_get_info(dev)
            if bank_bytes > 0.6 * total:
                raise RuntimeError(
                    f"sound bank ({bank_bytes / 2**30:.2f} GiB, one copy per "
                    f"device) exceeds 60% of the memory of {dev} "
                    f"({total / 2**30:.2f} GiB). Use bank_dtype='int16' (half "
                    f"the bytes), unload idle clips, or split the session "
                    f"across engines."
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

    def capture_trace(self, n_blocks: int, outdir: str) -> str:
        """Render `n_blocks` under torch.profiler and write a Chrome trace
        into `outdir` (chrome://tracing or Perfetto): CUDA and CPU activity
        on "cuda", CPU activity on "cpu". Host-side per-stage timing stays
        on `profiler` (BlockProfiler). Returns the trace's path."""
        from ..utils.profiling import device_trace

        with device_trace(outdir, self.device) as path:
            res = None
            for _ in range(max(1, int(n_blocks))):
                res = self.process_block()
            res.outputs.master.cpu()   # the last block's render, in the trace
        return path

    def warmup(self) -> int:
        """Build the CUDA kernel (windows fetch on the card), then render —
        from the current pool state, without advancing it — every (bucket,
        rung, kind) the session can dispatch, exactly the reference's work
        list: per-block renders (top rung only in a lookahead engine),
        horizons at each bucket's allowed rungs, and the full-pool gather
        fallback of a windows engine. A lookahead engine also starts both
        spec workers and renders the last item on the dispatch thread, so
        that thread's CUDA context and cuBLAS handle exist before the
        session. Ends in one real device->host transfer. Returns the number
        of renders (also `warmed_graphs`, in stats())."""
        if self.device.type == "cuda" and self.fetch.startswith("windows"):
            from .. import _build

            # before any worker can reach the kernel's first load
            _build.load()
        prog = self.pool.build_program(
            block_start_sample=float(self.clock.sample_position),
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick,
            lane_enabled=self.lane_enabled,
        )
        fused = fuse_packed(*pack_program(prog))
        sound = self._sound_data_for_backend()
        strips = self._packed_strips_for_backend()
        V = self.pool.num_voices
        H = self._lookahead
        hz = None
        if H:
            # a horizon's upload is base program + compact dynamics; an
            # all-zero dynamics matrix renders silent slices of that shape
            D = horizon_dyn_cols(self.pool.n_bq_extra)
            hz = np.concatenate(
                [fused, np.zeros((V, 1 + (H - 1) * D), np.int32)], axis=1)

        def warm_one(s, rmax, kind):
            fetch = self.fetch
            if rmax is None:  # over-envelope gather fallback (full pool)
                fetch, rmax = "gather", self.max_pitch_ratio
            if kind == "block":
                return sharding.render_block_sharded(
                    self.mesh, sound, fused[:s], strips,
                    block_frames=self.block_frames,
                    quirk_gain=self.quirk_gain, fetch=fetch,
                    max_pitch_ratio=rmax, pad_voices_to=V,
                )
            return sharding.render_horizon_sharded(
                self.mesh, sound, hz[:s], strips,
                block_frames=self.block_frames, slices=H,
                base_cols=fused.shape[1], quirk_gain=self.quirk_gain,
                fetch=fetch, max_pitch_ratio=rmax, pad_voices_to=V,
            )[0]

        work = []
        for s in self._bucket_ladder or [V]:
            block_rungs = (self._ratio_ladder[-1:] if H
                           else self._allowed_rungs(s))
            work += [(s, r, "block") for r in block_rungs]
            if H:
                work += [(s, r, "horizon") for r in self._allowed_rungs(s)]
        if self.fetch.startswith("windows"):
            work.append((V, None, "block"))
            if H:
                work.append((V, None, "horizon"))
        for w in work:
            out = warm_one(*w)
        if H:
            self._spec_sim_executor().submit(lambda: None).result()
            out = self._spec_executor().submit(warm_one, *work[-1]).result()
        out.master.cpu()
        self.warmed_graphs = len(work)
        return len(work)

    SLO_WORST_KEEP = 16

    def _note_slo_miss(self, kind: str, busy: float,
                       budget_blocks: int) -> None:
        """Record the context of a deadline miss; keep the top
        SLO_WORST_KEEP by overrun (busy time minus the kind's budget).
        Called only on a miss."""
        chain = self._h_next
        overrun = busy - budget_blocks * self.slo.budget
        worst = self._slo_worst
        worst.append({
            "kind": kind,
            "ms": round(busy * 1e3, 3),
            "overrun_ms": round(overrun * 1e3, 3),
            "budget_blocks": budget_blocks,
            "block": self.total_blocks,
            "h_cursor": self._h_cursor,
            "blocks_since_event": self._blocks_since_event,
            "chain": (None if chain is None else
                      ("dead" if chain.dead else chain._outstanding)),
        })
        if len(worst) > self.SLO_WORST_KEEP:
            worst.sort(key=lambda r: r["overrun_ms"], reverse=True)
            del worst[self.SLO_WORST_KEEP:]

    def _observe(self, busy: float, kind: str, budget_blocks: int = 1):
        """SLO and DSP-load accounting of one processed block."""
        if not self.slo.observe(busy, budget_blocks=budget_blocks, kind=kind):
            self._note_slo_miss(kind, busy, budget_blocks)
        self.dsp_load.observe(busy, budget_blocks=budget_blocks)

    def stats(self) -> dict:
        """Runtime health counters: SLO (deadline misses, per dispatch
        kind, the worst misses by overrun), DSP load, speculative-chain
        failures, and the event watchdog."""
        with self._stats_lock:
            spec_failures = self.spec_failures
            spec_last_failure = self.spec_last_failure
        return {
            "blocks": self.total_blocks,
            "warmed_graphs": self.warmed_graphs,
            "slo_missed": self.slo.missed_blocks,
            "slo_total": self.slo.total_blocks,
            "slo_worst_overrun_ms": round(self.slo.worst_overrun * 1e3, 3),
            # kind -> [missed, total, worst_overrun_ms]
            "slo_by_kind": {
                k: [v[0], v[1], round(v[2] * 1e3, 3)]
                for k, v in self.slo.by_kind.items()
            },
            "slo_worst": sorted(self._slo_worst,
                                key=lambda r: r["overrun_ms"], reverse=True),
            "dsp_load": round(self.dsp_load.load, 4),
            "spec_failures": spec_failures,
            "spec_last_failure": spec_last_failure,
            "watchdog_scheduled": self.watchdog.scheduled,
            "watchdog_delivered": self.watchdog.delivered,
            "watchdog_mismatches": self.watchdog.mismatches,
            "watchdog_lost": self.watchdog.lost,
        }

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

        # speculative lookahead: clean blocks emit pre-rendered horizon
        # slices (one upload per H blocks); event blocks rebuild the horizon
        # in-dispatch when traffic is sparse enough, else fall through to
        # the per-block dispatch below
        if self._lookahead:
            self._h_built_this_block = False
            self._spec_built_this_block = False
            self._adopted_this_block = False
            self._oob_preempt = False
            out = self._lookahead_outputs()
            event_block = self._block_dirty or self._oob_preempt
            self._block_dirty = False
            self._blocks_since_event = (
                0 if event_block else self._blocks_since_event + 1
            )
            if out is not None:
                self.clock.advance_block()
                self.total_blocks += 1
                busy = time.perf_counter() - _t0
                self.profiler.record("process_block", busy)
                # a horizon build or an adoption puts H blocks of audio in
                # hand: its deadline is H periods; a speculative-build
                # block's work must land before the slices still in hand
                # run out
                if self._h_built_this_block:
                    budget = self._lookahead
                    kind = "event_rebuild" if event_block else "horizon"
                elif self._adopted_this_block:
                    budget = max(1, len(self._h_slices))
                    kind = "adopt"
                elif self._spec_built_this_block:
                    budget = max(1, len(self._h_slices) - self._h_cursor)
                    kind = "spec"
                else:
                    budget = 1
                    kind = "emit"
                self._observe(busy, kind, budget)
                return BlockResult(outputs=out, midi_out=midi_out,
                                   tick_count=tick_count)

        # idle shortcut: with no live voices the render is identically zero —
        # skip the device dispatch
        if not self.pool.active.any():
            self.clock.advance_block()
            self.total_blocks += 1
            busy = time.perf_counter() - _t0
            self.profiler.record("process_block", busy)
            self._observe(busy, "idle")
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
        busy = time.perf_counter() - _t0
        self.profiler.record("process_block", busy)
        self._observe(busy, "per_block")
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
        # the fetched arrays carry everything the meters read: no tensor
        # reaches the host models
        self.levels.ingest_block(
            None,
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
        if peaks.shape[0] < self.pool.num_voices:
            # bucket-length peaks (the reference's mesh dispatch returns
            # them unpadded); inactive tail voices peaked at zero
            peaks = np.pad(peaks, (0, self.pool.num_voices - peaks.shape[0]))
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
