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

The reference's defaults are the port's on the CPU: the lookahead horizon
("auto": H=16 at B=128, H=2 at B=1024) and bucketed prefix rendering. On a
CUDA card "auto" resolves by the card's measurements (resolve_lookahead):
H=16 up to B=181, the per-block path above it. The reference's ratio ladder
(narrower windows regions when every pitch fits a lower rung) has no
counterpart: on the card it was never faster (PERF.md §6), so every windows
render covers `max_pitch_ratio`, the one envelope.
`mesh` (parallel/sharding.make_mesh) shards the voice axis over the mesh's
devices from this one process, as the reference's single controller does:
every per-block and horizon dispatch renders each shard's voices on its own
device and folds them into the lane mix carried from the shard before, in
pool voice order (ops/mixdown.py), so a mesh gives the unsharded engine's
bits; the outputs land on the first device, which is the engine's. Without
a mesh the engine's one device is the mesh: one shard, the same dispatch.
`render_dispatches` counts the per-block and horizon renders (each launches
the lane mixdown once a shard). Each render replays the CUDA graphs captured
for its (kind, bucket, fetch) by warmup() or when first met (engine/graphs.py,
the reference's compile-once jit executables): one graph on one card, k
shards of it included, a chain of per-card graphs across cards.
`render_graphs="off"` enqueues every kernel eagerly.

Two of the reference's faults are not carried over: the speculation depth
(LIBZL_TPU_SPEC_DEPTH) is parsed at engine construction and a bad value
raises, and the `slo_worst` context ring ranks misses by overrun (busy time
minus budget), not by busy time.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
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
    POSITION_COUNT,
    SAMPLER_CHANNEL_MAX,
    SAMPLER_CHANNEL_MIN,
    channel_to_lane,
)
from ..device import resolve_device
from ..midi.router import MidiRouter
from ..midi.transport import TransportManager
from ..models.audio_levels import AudioLevels
from ..models.feedback import FeedbackTable
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
from ..utils import profiling
from ..utils.profiling import (
    BlockProfiler,
    DspLoad,
    EventWatchdog,
    SloCounter,
)
from . import graphs as graphs_mod
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

    def __init__(self, eng, gen, end_snap, start, block, lane, anchor,
                 sound, strips, depth: int):
        self.eng = eng
        self.gen = gen
        self.end_snap = end_snap
        self.start = float(start)
        # the block the next link starts at, and the engine's span that
        # launched the chain or adopted its last link (the cause of the
        # worker spans it records, profiling.current())
        self.block = int(block)
        self.cause = None
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
        self.cause = profiling.current()
        self.eng._spec_sim_executor().submit(self._step)

    def advance(self) -> None:
        """One link was adopted: refill the speculation depth."""
        self.cause = profiling.current()
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
            block = self.block
            with eng.profiler.span("spec_sim", block=block,
                                   parent=self.cause) as sim:
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

            def guarded_dispatch(cause=sim.id):
                # a killed chain's queued dispatches must not hold up the
                # dispatch thread for the real ones behind them
                if self.dead or eng._spec_gen != self.gen:
                    return None
                with eng.profiler.span("spec_dispatch", block=block,
                                       parent=cause):
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
            self.block += len(snaps)
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


def _reference_lookahead(block_frames: int) -> int:
    """The reference's "auto" on its accelerator: a 2048-frame window, at
    most 16 blocks (libzl_tpu/engine/engine.py, chosen on the TPU)."""
    return (max(min(16, 2048 // block_frames), 0)
            if block_frames <= 2048 else 0)


# "auto" on a CUDA card, from five sweeps of chip_smoke.py --policy-only on
# an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §5, "Dispatch defaults"):
# at each measured B the H that most sweeps decided by PERF.md's rule,
# 16 at B=128, 0 (the per-block path) at B=256 and B=1024. A block size
# between measured ones takes the decision of the nearer one on a log
# scale: the horizon's side ends at sqrt(128 * 256) ~ 181 frames.
CARD_LOOKAHEAD_MAX_FRAMES = 181
CARD_LOOKAHEAD = 16


def _card_lookahead(block_frames: int) -> int:
    """"auto" on a CUDA card: CARD_LOOKAHEAD blocks up to
    CARD_LOOKAHEAD_MAX_FRAMES a block, else the per-block path."""
    return (CARD_LOOKAHEAD if block_frames <= CARD_LOOKAHEAD_MAX_FRAMES
            else 0)


def resolve_lookahead(lookahead, block_frames: int, device_type: str) -> int:
    """The horizon depth H for an engine's `lookahead` option: "auto" is
    _card_lookahead on "cuda" and the reference's rule elsewhere (the CPU,
    as the reference's jax engine resolves it); an int is taken as it is.
    0 is the per-block path, and so is 1."""
    if lookahead == "auto":
        H = (_card_lookahead(block_frames) if device_type == "cuda"
             else _reference_lookahead(block_frames))
    else:
        H = max(int(lookahead), 0)
    return 0 if H == 1 else H


@dataclasses.dataclass
class BlockResult:
    """Host-visible outputs of one processed block."""

    outputs: render_mod.RenderOutputs   # tensors on the engine's device
    midi_out: list                      # [(frame_offset, bytes), ...]
    tick_count: int


class AudioEngine:
    # applied re-renders kept in `applied_renders`
    RENDER_RECORD_KEEP = 4096

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
        mesh=None,
        render_graphs: str = "auto",
    ):
        if voice_buckets not in ("auto", "off"):
            raise ValueError("voice_buckets must be 'auto' or 'off'")
        if render_graphs not in ("auto", "off"):
            raise ValueError("render_graphs must be auto|off")
        # the speculative chain's depth, checked here and not mid-session
        self._spec_depth = spec_depth_from_env()
        # explicit device: "cuda" without a card raises (device.py)
        self.device = resolve_device(device)
        # the voice axis shards over the mesh (default: the engine's one
        # device); the engine's device is the mesh's first, where the lane
        # mix lands and the strip/meter tail runs (parallel/sharding.py)
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
        # Render graphs (engine/graphs.py), the reference's compile-once
        # executables: "auto" captures each (kind, bucket, fetch) render in a
        # CUDA graph (its plain version on the CPU) and replays it, one
        # launch a block or horizon, on a mesh too (one graph a render on
        # one card, a chain of per-card graphs across cards: the plan is
        # sharding.segments); "off" dispatches every render eagerly, for
        # comparing the two.
        self.render_graphs = render_graphs
        self._graphs = (graphs_mod.RenderGraphs(mesh.devices[0],
                                                sharding.segments(mesh))
                        if render_graphs == "auto" else None)
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
            # like the reference, at construction, then drop it (one CUDA
            # kernel serves every variant)
            parse_suffix(fetch.partition(":")[2])
            fetch = "windows"
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
        # see _fits_envelope).
        if not 1.0 <= float(max_pitch_ratio) <= 4.0:
            raise ValueError("max_pitch_ratio must be within [1.0, 4.0]")
        self.max_pitch_ratio = float(max_pitch_ratio)
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
        # "auto" on the CPU fills a 2048-frame window (the reference's
        # choice, made on the TPU); on a card it is _card_lookahead, the
        # card's own measurement (the horizon moves the render's enqueue
        # from the engine thread to the speculative chain's dispatch
        # thread).
        self._lookahead = resolve_lookahead(lookahead, block_frames,
                                            self.device.type)
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
        # the bank's mutations through this engine since the device's
        # version: (version before, version after, first frame, end frame)
        # of each; _sound_data_for_backend copies only those frames while
        # they account for every version between
        self._bank_edits: list = []
        # what the bank's refreshes moved: bytes copied to the devices,
        # full uploads (the whole capacity converted) and region-only ones
        self.bank_upload_bytes = 0
        self.bank_uploads_full = 0
        self.bank_uploads_partial = 0
        self._device_sound_data = None
        self._device_strips = None
        self._host_strips_snapshot = None
        # rendered blocks by the fetch they rendered with: per-block
        # dispatches and horizon slices (speculative ones included, whether
        # adopted or discarded). The dispatch thread adds too, under
        # _stats_lock, as it does to the spec failure count.
        self._stats_lock = threading.Lock()
        self.fetch_dispatches = {"windows": 0, "gather": 0}
        # renders dispatched (each launches the lane mixdown once a shard:
        # a per-block block, or a horizon's H slices stacked)
        self.render_dispatches = {"block": 0, "horizon": 0}
        # graphs first captured mid-session (the reference's mid-session
        # compile), not by warmup() or a rebind
        self.late_captures = 0
        # speculative builds or dispatches that raised (the engine then
        # falls back to a synchronous horizon) and the last one's traceback
        self.spec_failures = 0
        self.spec_last_failure: Optional[str] = None
        # the lookahead's useful work: horizon slices rendered (H a horizon
        # dispatched, synchronous or speculative, discarded ones included;
        # under _stats_lock) and emitted (the engine thread's): rendered
        # less emitted is the work speculation threw away
        self.lookahead_slices_rendered = 0
        self.lookahead_slices_emitted = 0
        # the played notes' path: the note-ons and note-offs of the blocks'
        # scheduled MIDI, start commands that claimed no voice, and renders
        # whose rows (the bucket, or the full pool) differ from the last
        # render's (under _stats_lock: the dispatch thread renders too)
        self.note_ons = 0
        self.note_offs = 0
        self.starts_dropped = 0
        self.bucket_changes = 0
        self._last_render_rows = None

        self.strips = default_strip_params(render_mod.NUM_STRIPS)
        # GlobalPlayback strip gets its wets zeroed (lib/MidiRouter.cpp:876-880)
        self.strips.wet1[0] = 0.0
        self.strips.wet2[0] = 0.0
        self.lane_enabled = np.ones(NUM_SAMPLER_CHANNELS, bool)

        self.clips: dict[int, object] = {}
        # every clip's positions and throttled progress and level state,
        # which update_session publishes in one pass: a position row for
        # every voice and for positions made through the models' API
        self.feedback = FeedbackTable(num_voices + POSITION_COUNT,
                                      clips=16)
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
        # each applied re-render, the last RENDER_RECORD_KEEP: (the block
        # it takes effect at, the clip's id, the clip's render generation),
        # a synchronous reload and a deferred one alike; and their count
        self.applied_renders: "collections.deque" = collections.deque(
            maxlen=self.RENDER_RECORD_KEEP)
        self.renders_applied = 0
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
        # per-stage host wall time (utils/profiling): a block is the span
        # process_block, holding commands (notes, in a note block), then
        # lookahead (emit, adopt_wait, horizon_build) or host_program and
        # dispatch (the graph replay's parts, graphs.DISPATCH_SPANS); the
        # speculative workers record spec_sim and spec_dispatch on it too
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
        v0 = self.bank.version
        clip.slot = self.bank.load(clip.playback_audio)
        self._note_bank_edit(v0, clip.slot)
        self.clips[clip.id] = clip
        self.feedback.attach(clip)

    def reload_clip_sound(self, clip) -> None:
        """playbackFileChanged analog (lib/SamplerSynthSound.cpp:68),
        recorded in `applied_renders` with the block it takes effect at."""
        # pool state is about to change: discard any horizon first
        self._mark_event()
        v0 = self.bank.version
        clip.slot = self.bank.replace(clip.slot.slot, clip.playback_audio)
        self._note_bank_edit(v0, clip.slot)
        # live voices switch to the new render at the next block, like the
        # reference's per-block buffer re-read (SamplerSynthVoice.cpp:189-191)
        self.pool.rebase_clip(clip.id, clip.slot.base, clip.slot.length)
        self.applied_renders.append(
            (self.total_blocks, clip.id, clip._render_generation))
        self.renders_applied += 1

    def unregister_clip(self, clip) -> None:
        if clip.id in self.clips:
            del self.clips[clip.id]
        self.feedback.detach(clip)
        if clip.slot is not None:
            v0 = self.bank.version
            self.bank.unload(clip.slot.slot)
            self._note_bank_edit(v0, None)
            clip.slot = None

    def _note_bank_edit(self, v0: int, slot) -> None:
        """One mutation of the bank, from version `v0` to its version now:
        the frames of `slot`'s region it wrote, none for an unload (which
        writes no frame)."""
        lo = hi = 0
        if slot is not None:
            lo, hi = slot.base, slot.base + slot.padded_length
        self._bank_edits.append((v0, self.bank.version, lo, hi))

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
        # the pool numbers each voice it starts: a start that leaves the
        # next number as it was claimed none
        claimed = self.pool._next_position_id
        self.allocator.handle(cmd, clip, tick, frame_offset)
        if cmd.start_playback and self.pool._next_position_id == claimed:
            self.starts_dropped += 1
        for cb in self.clip_command_sent_callbacks:
            cb(cmd)

    def _route_midi(self, midi_out: list) -> None:
        """A block's MIDI through the fabric: the router (internal, then
        hardware input), the transport's passthrough, the sampler map (a
        note to a start or stop command, through the allocator) and the
        external outputs."""
        router = self.router
        router.begin_block()
        router.route_internal(midi_out)
        router.route_hardware()
        self.transport.handle_passthrough(router.passthrough_out)
        self.sampler_map.handle(router, router.passthrough_out)
        router.flush_external()

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

    def _fits_envelope(self, prog_i, prog_f) -> bool:
        """Whether every active voice's pitch ratio this block fits the
        windows envelope (`max_pitch_ratio`). When one does not, the
        dispatch routes through the region-free GATHER fetch at the full
        pool, which supports the reference's unbounded pitchRatio
        (lib/SamplerSynthVoice.cpp:115-116). Gather engines never fall
        back."""
        if self.fetch != "windows":
            return True
        act = prog_i[:, _INT_SCALARS.index("active")] != 0
        if not act.any():
            return True
        ratio = (prog_i[:, _INT_SCALARS.index("rate_int")]
                 + prog_f[:, _F32_SCALARS.index("rate_frac")])
        return float(np.max(np.where(act, ratio, 0.0))) <= self.max_pitch_ratio

    def _fetch_kind(self, fetch: str) -> str:
        return "gather" if self.quirk_gain else fetch

    def _count_render(self, kind: str, blocks: int, dispatch: str,
                      rows: int) -> None:
        with self._stats_lock:
            self.fetch_dispatches[kind] += blocks
            self.render_dispatches[dispatch] += 1
            if dispatch == "horizon":
                self.lookahead_slices_rendered += blocks
            if rows != self._last_render_rows:
                if self._last_render_rows is not None:
                    self.bucket_changes += 1
                self._last_render_rows = rows

    def _note_spec_failure(self, exc: BaseException) -> None:
        with self._stats_lock:
            self.spec_failures += 1
            self.spec_last_failure = "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__))

    def _dispatch_packed(self, sound, prog_i, prog_f, strips_packed):
        bucket = self._render_bucket(prog_i)
        fetch = self.fetch
        if not self._fits_envelope(prog_i, prog_f):
            # over-envelope pitch: the region-free gather at full pool
            fetch, bucket = "gather", None
        V = self.pool.num_voices
        n = V if bucket is None else min(bucket, V)
        self._count_render(self._fetch_kind(fetch), 1, "block", n)
        # ONE host->device buffer per shard and block (its rows of the
        # bucket's prefix of the pool): the program pair fuses into a single
        # int32 matrix (f32 columns bit-cast), uploaded from pinned memory on
        # CUDA (a graph's own staging buffer) so the host runs ahead of the
        # card
        return self._render("block", fetch,
                            fuse_packed(prog_i[:n], prog_f[:n]), sound,
                            strips_packed)

    def _render_fn(self, kind: str, fetch: str, sound, strips, cols: int):
        """The render of one (kind, fetch) on `sound` and `strips`, a
        sharding.ShardedRender: called on the program (a host array, or the
        device tensor a graph captures) it is the eager dispatch; its steps
        are what the graphs record."""
        H = self._lookahead if kind == "horizon" else 0
        # a horizon's base program columns: the rest are the compact
        # dynamics
        base = (cols - (1 + (H - 1) * horizon_dyn_cols(self.pool.n_bq_extra))
                if H else 0)
        return sharding.ShardedRender(
            self.mesh, sound, strips, self.block_frames, self.quirk_gain,
            fetch, self.max_pitch_ratio, self.pool.num_voices, H, base)

    def _graph_key(self, kind: str, n: int, fetch: str,
                   sound) -> graphs_mod.GraphKey:
        # what can differ between two renders of one engine: the horizon's
        # slices, quirk_gain and the bank's layout are the engine's for life
        bank = next(iter(sound.values()))
        return graphs_mod.GraphKey(kind, n, fetch,
                                   (tuple(bank.shape), str(bank.dtype)))

    def _render(self, kind: str, fetch: str, prog, sound, strips,
                late: bool = True):
        """One render of `prog` (a block's fused program, or a horizon's
        one buffer, int32 on the host): a replay of its graphs, captured
        the first time it is met (counted in `late_captures` unless `late`
        is False), or, with render_graphs "off", the eager dispatch. A
        RenderOutputs, or a tuple of H for a horizon."""
        if self._graphs is None:
            return self._render_fn(kind, fetch, sound, strips,
                                   prog.shape[1])(prog)
        key = self._graph_key(kind, prog.shape[0], fetch, sound)
        # the render itself (a ShardedRender) only where no graph replays
        out = self._graphs.replay(key, prog, warm=not late,
                                  profiler=self.profiler)
        if out is not None:
            return out
        fn = self._render_fn(kind, fetch, sound, strips, prog.shape[1])
        out, captured = self._graphs.render(key, fn, prog, sound,
                                            warm=not late,
                                            profiler=self.profiler)
        if captured and late:
            with self._stats_lock:
                self.late_captures += 1
        return out

    def _recapture(self, key: graphs_mod.GraphKey, cols: int) -> tuple:
        """A graph's key and render on the engine's current bank and
        strips (RenderGraphs.rebind)."""
        sound, strips = self._device_sound_data, self._device_strips
        key = self._graph_key(key.kind, key.voices, key.fetch, sound)
        return key, self._render_fn(key.kind, key.fetch, sound, strips, cols)

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
        self.lookahead_slices_emitted += 1
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
        """Resolve what a compact-horizon dispatch needs (bucket, fetch, the
        one int32 buffer of base program and dynamics) and return a
        zero-argument closure that renders the H slices (_render: a graph
        replay, or the upload and eager enqueue), touching no engine state
        but the counts. The speculative path runs the closure on the
        dispatch worker: it launches on that thread's current stream (the
        legacy default stream, the engine thread's too), each shard inside
        its own device."""
        H = self._lookahead
        hz = np.concatenate([fuse_packed(prog_i0, prog_f0), dyn], axis=1)
        if sound is None:
            sound = self._sound_data_for_backend()
        if strips is None:
            strips = self._packed_strips_for_backend()
        # slice 0 bounds the whole horizon: no events land mid-horizon by
        # construction, so the active high-water and the pitch-ratio
        # envelope can only shrink across slices
        bucket = self._render_bucket(prog_i0)
        V = self.pool.num_voices
        fetch = self.fetch
        if not self._fits_envelope(prog_i0, prog_f0):
            # over-envelope pitch: the region-free gather at full pool
            fetch, bucket = "gather", None
        if bucket is not None and bucket < V:
            hz = hz[:bucket]
        kind = self._fetch_kind(fetch)

        def dispatch() -> list:
            outs = self._render("horizon", fetch, hz, sound, strips)
            self._count_render(kind, H, "horizon", hz.shape[0])
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
        # the link's first block: this block (not yet counted) plus the
        # slices between its start and the link's
        block_next = self.total_blocks + 1 + round(
            (start_next - float(self.clock.sample_position))
            / self.block_frames)
        chain = _SpecChain(
            self, self._spec_gen, end_snap, start_next, block_next,
            lane, anchor, self._sound_data_for_backend(),
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
        may fetch any sample).

        A new version is copied into the tensors in place while the bank's
        capacity holds: a render graph reads the bank where it lay at
        capture. The copy is ordered on this thread's current stream, after
        every render enqueued there before it and before every later one
        (the engine thread and the speculative dispatch thread both launch
        on the legacy default stream). Where the engine recorded every
        mutation since the device's version (register_clip, reload_clip_sound,
        unregister_clip: `_bank_edits`), only the frames they wrote are
        converted and copied; any other version change converts the whole
        capacity. When the capacity grows, a new device bank is made and
        every graph is captured again on it (RenderGraphs.rebind,
        `graph_recaptures` in stats()): after recorded mutations the old
        bank is copied into it on the device and only their frames come
        from the host, else the whole bank is uploaded. Span
        `bank_upload`."""
        if self._bank_version_on_device != self.bank.version:
            with self.profiler.span("bank_upload"):
                self._upload_bank()
        return self._device_sound_data

    def _upload_bank(self) -> None:
        """Bring every device copy of the bank to `bank.version`."""
        planar = self.fetch == "windows"
        ranges = self._bank_delta()
        self._bank_edits = []
        old = self._device_sound_data
        cap = self.bank.capacity_frames
        shape = (2, cap) if planar else (cap, 2)
        dtype = torch.int16 if self.bank_dtype == "int16" else torch.float32
        axis = 1 if planar else 0
        # device copies of this dtype and layout, no longer than the bank
        same = old is not None and all(
            t.dtype == dtype and t.dim() == 2 and t.shape[1 - axis] == 2
            and t.shape[axis] <= cap for t in old.values())
        if same and all(t.shape[axis] == cap for t in old.values()):
            # a version change the engine did not record: the whole
            # capacity, through the same in-place copy
            full = ranges is None
            self._copy_ranges(old, [(0, cap)] if full else ranges)
            if full:
                self.bank_uploads_full += 1
            else:
                self.bank_uploads_partial += 1
        elif same and ranges is not None and self._fits_beside(old):
            # a recorded growth: the old bank copied into the new one on
            # each device, the rest zeros as in bank.data, then only the
            # written regions from the host
            self._check_bank_capacity()
            grown = {}
            for dev, t in old.items():
                n = t.shape[axis]
                g = torch.empty(shape, dtype=dtype, device=dev)
                g.narrow(axis, 0, n).copy_(t)
                g.narrow(axis, n, cap - n).zero_()
                grown[dev] = g
            old = None
            self._copy_ranges(grown, ranges)
            self._bind_bank(grown)
            self.bank_uploads_partial += 1
        else:
            # a new size: the capacity check, then the whole bank
            self._check_bank_capacity()
            host = torch.from_numpy(convert.sound_bank_array(
                self.bank.data, self.bank_dtype,
                "planar" if planar else "interleaved"))
            self._device_sound_data = old = None  # free the old copies first
            self._bind_bank({dev: host.to(dev, copy=True)
                             for dev in self.mesh.distinct()})
            self.bank_upload_bytes += host.nbytes * len(
                self._device_sound_data)
            self.bank_uploads_full += 1
        self._bank_version_on_device = self.bank.version

    def _copy_ranges(self, tensors: dict, ranges) -> None:
        """Convert the frames [lo, hi) of each range of bank.data and copy
        them into every device tensor, in place."""
        planar = self.fetch == "windows"
        layout = "planar" if planar else "interleaved"
        data = self.bank.data
        for lo, hi in ranges:
            # planar: one contiguous run a channel, in the device tensor
            # and in bank.data (a float32 run converts without a copy)
            pieces = ([((slice(c, c + 1), slice(lo, hi)),
                        data[c:c + 1, lo:hi]) for c in (0, 1)]
                      if planar else [(slice(lo, hi), data[:, lo:hi])])
            for index, src in pieces:
                part = torch.from_numpy(convert.sound_bank_array(
                    src, self.bank_dtype, layout))
                for t in tensors.values():
                    t[index].copy_(part)
                self.bank_upload_bytes += part.nbytes * len(tensors)

    def _fits_beside(self, old: dict) -> bool:
        """Whether the grown bank fits each card beside the old copy it is
        copied from, within the capacity check's share of the card."""
        itemsize = 2 if self.bank_dtype == "int16" else 4
        need = self.bank.data.size * itemsize + max(
            t.numel() * t.element_size() for t in old.values())
        return all(dev.type != "cuda"
                   or need <= 0.6 * self._device_memory(dev)
                   for dev in old)

    def _bind_bank(self, tensors: dict) -> None:
        """The bank's device copies are now `tensors`: every graph is
        captured again on them."""
        self._device_sound_data = tensors
        if self._graphs is not None:
            # recaptured and warm-replayed on this thread only: a warm on
            # the dispatch thread would hold the GIL against the blocks
            # that follow (PERF.md §5)
            self._graphs.rebind(tensors, self._recapture)

    def _bank_delta(self):
        """The frame ranges written since the device's version, sorted and
        merged; None where the recorded mutations do not lead, version by
        version, from the device's version to the bank's."""
        v = self._bank_version_on_device
        ranges = []
        for v0, v1, lo, hi in self._bank_edits:
            if v0 != v:
                return None
            v = v1
            if hi > lo:
                ranges.append((lo, hi))
        if v != self.bank.version:
            return None
        merged: list = []
        for lo, hi in sorted(ranges):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return merged

    def _check_bank_capacity(self) -> None:
        """The bank must fit each card that holds it beside the render's
        working set: fail loudly at upload time instead of running out of
        memory mid-performance."""
        itemsize = 2 if self.bank_dtype == "int16" else 4
        bank_bytes = self.bank.data.size * itemsize
        for dev in self.mesh.distinct():
            if dev.type != "cuda":
                continue
            total = self._device_memory(dev)
            if bank_bytes > 0.6 * total:
                raise RuntimeError(
                    f"sound bank ({bank_bytes / 2**30:.2f} GiB, one copy per "
                    f"device) exceeds 60% of the memory of {dev} "
                    f"({total / 2**30:.2f} GiB). Use bank_dtype='int16' (half "
                    f"the bytes), unload idle clips, or split the session "
                    f"across engines."
                )

    @staticmethod
    def _device_memory(dev) -> int:
        """The card's memory in bytes, from its properties (a query of its
        free memory takes tens of ms)."""
        return torch.cuda.get_device_properties(dev).total_memory

    def _packed_strips_for_backend(self):
        """Strips change rarely (UI gestures): keep one device copy and
        write it in place, ordered like the bank's copy
        (_sound_data_for_backend), only when the packed values change."""
        packed = pack_strips(self.strips)
        if self._device_strips is None:
            self._device_strips = convert.strips_tensor(self.strips,
                                                        self.device)
        elif not np.array_equal(packed, self._host_strips_snapshot):
            self._device_strips.copy_(torch.from_numpy(packed))
        self._host_strips_snapshot = packed
        return self._device_strips

    def capture_trace(self, n_blocks: int, outdir: str) -> str:
        """Render `n_blocks` under torch.profiler and write a Chrome trace
        into `outdir` (chrome://tracing or Perfetto): CUDA and CPU activity
        on "cuda", CPU activity on "cpu", and the program's spans of every
        thread meanwhile (utils/profiling's record, recording for the
        capture if it was not), on the same clock. Returns the trace's
        path."""
        n = max(1, int(n_blocks))
        started = not profiling.recording()
        if started:
            profiling.start_recording(4096 + 64 * n)
        since = profiling.mark()
        try:
            with profiling.device_trace(outdir, self.device) as path:
                res = None
                for _ in range(n):
                    res = self.process_block()
                # the last block's render, in the trace
                res.outputs.master.cpu()
                # the speculative dispatch thread may be replaying a render
                # graph, and the profiler's stop deadlocks against a graph
                # launch on another thread (seen on the H100): let it
                # finish
                self.drain_speculation()
        finally:
            if started:
                profiling.stop_recording()
        profiling.add_to_chrome_trace(path,
                                      profiling.export(since)["spans"])
        return path

    def warmup(self) -> int:
        """Pay every cold start at boot, never inside the realtime pump (the
        reference's contract). Build the CUDA kernels (the lane mixdown on
        every card render, the windows fetch too), then capture a render
        graph — from the current pool state, without advancing it — for
        every (bucket, kind) the session can dispatch, the reference's work
        list at one rung: a block at each bucket, a horizon at each bucket
        in a lookahead engine, and a windows engine's full-pool gather
        fallback (its block, and its horizon in a lookahead engine). A
        graph already captured is replayed instead; with render_graphs
        "off" each item renders once. Then every graph is replayed from
        both staging slots on this thread (RenderGraphs.warm: its first
        launch, clone and copies), and a lookahead engine starts both spec
        workers and replays the horizon graphs on the dispatch thread too
        (without graphs: renders the last item there), so that thread's
        CUDA context exists before the session. The native host core's first
        voice_update runs from the pool's state, which is then put back
        (_warm_host_core). Ends in one real device->host transfer. Returns
        the number of items (also `warmed_graphs`, in stats(): with graphs,
        each is one graph held)."""
        if self.device.type == "cuda":
            from .. import _build

            # before any worker can reach the kernels' first load
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

        def warm_one(s, fetch, kind):
            if kind == "block":
                return self._render(kind, fetch, fused[:s], sound, strips,
                                    late=False)
            return self._render(kind, fetch, hz[:s], sound, strips,
                                late=False)[0]

        kinds = ("block", "horizon") if H else ("block",)
        work = [(s, self.fetch, kind)
                for s in self._bucket_ladder or [V] for kind in kinds]
        if self.fetch == "windows":
            # the over-envelope gather fallback (full pool)
            work += [(V, "gather", kind) for kind in kinds]
        for w in work:
            out = warm_one(*w)
        g = self._graphs
        if g is not None:
            g.warm()
        if H:
            self._spec_sim_executor().submit(lambda: None).result()
            if g is None:
                out = self._spec_executor().submit(warm_one,
                                                   *work[-1]).result()
            else:
                self._spec_executor().submit(
                    g.warm, [k for k in g.keys()
                             if k.kind == "horizon"]).result()
        if self.use_native_host:
            self._warm_host_core()
        out.master.cpu()
        self.warmed_graphs = len(work)
        return len(work)

    def _warm_host_core(self) -> None:
        """The native host core's first voice_update, on the engine's own
        pool and lane buffer (its pointer cache, hostcore._build_state, then
        holds the session's first blocks' arguments), from the pool's
        current state, which is put back."""
        snap = self.pool.save_state()
        _hostcore.voice_update(
            self.pool, lane_enabled=self.lane_enabled,
            block_start_sample=float(self.clock.sample_position),
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick)
        self.pool.restore_state(snap)

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
        failures, the lookahead's slices rendered and emitted, the played
        notes' path (note_ons, note_offs, starts_dropped, bucket_changes),
        the event watchdog, the session update's passes and the clips
        that entered Python in them, the re-renders applied and the bank's
        uploads (bytes, full and region-only)."""
        with self._stats_lock:
            spec_failures = self.spec_failures
            spec_last_failure = self.spec_last_failure
            late_captures = self.late_captures
            slices_rendered = self.lookahead_slices_rendered
            bucket_changes = self.bucket_changes
        g = self._graphs
        return {
            "blocks": self.total_blocks,
            "warmed_graphs": self.warmed_graphs,
            # "graphs": renders replay captured graphs; "eager": every
            # render enqueues its kernels (render_graphs "off")
            "render_graphs": "eager" if g is None else "graphs",
            "graphs": 0 if g is None else len(g),
            # the graphs a key chains: 1 on one device, one a card across
            # cards (sharding.segments)
            "graph_segments": 0 if g is None else len(g.plan),
            "graph_replays": 0 if g is None else g.replays,
            # replays off the books of graph_replays, each graph once from
            # each staging slot: at warmup on each thread that replays it in
            # realtime, after a recapture on the thread that grew the bank
            "graph_warm_replays": 0 if g is None else g.warm_replays,
            # of graph_replays, those through the native call (a one-card
            # graph drawing nothing from the CUDA generator: all of them
            # on one card, none on the CPU or across cards)
            "native_replays": 0 if g is None else g.native_replays,
            # output slots made (graphs._OutRing), and replays that found
            # none free under the ring's cap and cloned their outputs
            "out_slots": 0 if g is None else g.out_slots,
            "out_slot_fallbacks": 0 if g is None else g.out_slot_fallbacks,
            "late_captures": late_captures,
            "graph_recaptures": 0 if g is None else g.recaptures,
            # renders whose bank was replaced while they waited (run once
            # without a graph; a speculative one is then discarded)
            "graph_stale_renders": 0 if g is None else g.stale,
            "graph_capture_s": 0.0 if g is None else g.capture_seconds,
            # device memory the graphs hold: their pools' growth at capture
            # plus the static buffers
            "graph_bytes": 0 if g is None else g.bytes,
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
            "lookahead_slices_rendered": slices_rendered,
            "lookahead_slices_emitted": self.lookahead_slices_emitted,
            "note_ons": self.note_ons,
            "note_offs": self.note_offs,
            "starts_dropped": self.starts_dropped,
            "bucket_changes": bucket_changes,
            "watchdog_scheduled": self.watchdog.scheduled,
            "watchdog_delivered": self.watchdog.delivered,
            "watchdog_mismatches": self.watchdog.mismatches,
            "watchdog_lost": self.watchdog.lost,
            # session updates (FeedbackTable.update passes), and the clips
            # that entered Python in them: a listener or callback fired,
            # or a position was reaped
            "session_updates": self.feedback.updates,
            "session_clip_visits": self.feedback.visits,
            # re-renders swapped in (reload_clip_sound: `applied_renders`
            # holds the last ones with their blocks), and the bank's
            # refreshes: bytes copied to the devices, whole-capacity
            # uploads and region-only ones
            "renders_applied": self.renders_applied,
            "bank_upload_bytes": self.bank_upload_bytes,
            "bank_uploads_full": self.bank_uploads_full,
            "bank_uploads_partial": self.bank_uploads_partial,
        }

    def process_block(self) -> BlockResult:
        """Render one block: drain due ticks, dispatch, advance. One span,
        process_block: the commands (the deferred renders swapped in inside
        `render_swap`, the fabric inside `notes` in a block whose MIDI
        carries a note), then the lookahead or the per-block dispatch (a
        bank refresh inside `bank_upload`); its time is the block's SLO and
        DSP-load observation."""
        prof = self.profiler
        with prof.span("process_block", block=self.total_blocks + 1) as span:
            result, kind, budget = self._render_next(prof)
        self._observe(span.seconds, kind, budget)
        return result

    def _render_next(self, prof) -> tuple:
        """process_block's body: (BlockResult, SLO kind, budget in
        blocks)."""
        with prof.span("commands"):
            # swap in any completed deferred clip renders (the worker appends;
            # deque.popleft is atomic so no append can be lost to a list swap)
            if self._pending_renders:
                with prof.span("render_swap"):
                    while True:
                        try:
                            fn = self._pending_renders.popleft()
                        except IndexError:
                            break
                        fn()
            midi_out: list[tuple[int, bytes]] = []
            if self._pending_immediate_midi:
                midi_out.extend(
                    (0, data) for data in self._pending_immediate_midi)
                self._pending_immediate_midi = []

            # Dynamic tick walk: tick spacing re-derives after every
            # tick's commands, so a SetBpm firing mid-block changes the
            # spacing of the REMAINING ticks in the same block
            # (lib/SyncTimer.cpp:636-641). The per-block transport BPM is
            # the time-weighted blend of the per-tick BPMs, rounded to 2
            # decimals (lib/SyncTimer.cpp:644,672-673).
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
                        midi_out.append(
                            (offset, bytes([MIDI_BEAT_CLOCK_BYTE])))
                step = self.ring.pop_next()
                for ev in step.midi:
                    midi_out.append((offset, ev.data))
                for ccmd in step.clip_commands:
                    self._apply_clip_command(ccmd, t, offset)
                for tcmd in step.timer_commands:
                    self._apply_timer_command(tcmd, t, offset)
                tick_count += 1
                if self.clock.tick_position != t:
                    # a transport reset (stop flush) re-based the musical
                    # clock; resume the walk from the new position
                    t = self.clock.tick_position
                else:
                    t += 1
            self.clock.tick_position = t
            bpm_blend += self.clock.bpm * (block_end - seg_start)
            self.period_bpm = (
                round(bpm_blend / self.block_frames * 100.0) / 100.0
            )

            # MIDI routing fabric: transport ticks, internal + hardware
            # routing, transport control, note->sampler mapping (all
            # sample-offset aware)
            self.transport.emit_ticks(
                self.clock.sample_position, self.block_frames, midi_out
            )
            # a note block (its scheduled MIDI carries a note-on or off)
            # routes inside the span "notes": its window count is the note
            # blocks, its total their cost
            ons = offs = 0
            for _, data in midi_out:
                # midi.messages' is_note_on / is_note_off, inline: a quiet
                # block's clock bytes cost one compare each
                if data and 0x7F < data[0] < 0xA0:
                    if data[0] < 0x90:
                        offs += 1
                    elif len(data) > 2:
                        if data[2]:
                            ons += 1
                        else:
                            offs += 1
            if ons or offs:
                self.note_ons += ons
                self.note_offs += offs
                with prof.span("notes"):
                    self._route_midi(midi_out)
            else:
                self._route_midi(midi_out)
            # event watchdog: everything that entered the fabric this
            # block must have reached a terminal (sink append or
            # intentional swallow)
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
            with prof.span("lookahead"):
                out = self._lookahead_outputs()
            event_block = self._block_dirty or self._oob_preempt
            self._block_dirty = False
            self._blocks_since_event = (
                0 if event_block else self._blocks_since_event + 1
            )
            if out is not None:
                self.clock.advance_block()
                self.total_blocks += 1
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
                return (BlockResult(outputs=out, midi_out=midi_out,
                                    tick_count=tick_count), kind, budget)

        # idle shortcut: with no live voices the render is identically zero —
        # skip the device dispatch
        if not self.pool.active.any():
            self.clock.advance_block()
            self.total_blocks += 1
            return BlockResult(
                outputs=self._zero_outputs(), midi_out=midi_out,
                tick_count=tick_count,
            ), "idle", 1

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
            with prof.span("host_program"):
                prog_i, prog_f, died_info = _hostcore.voice_update(
                    self.pool, lane_enabled=self.lane_enabled, **clock_args
                )
            with prof.span("dispatch"):
                outputs = self._dispatch_packed(sound, prog_i, prog_f, strips)
            died_pairs = [(cid, pid) for _, cid, pid in died_info]
        else:
            with prof.span("host_program"):
                prog = self.pool.build_program(
                    lane_enabled=self.lane_enabled, **clock_args
                )
                prog_i, prog_f = pack_program(prog)
            with prof.span("dispatch"):
                outputs = self._dispatch_packed(sound, prog_i, prog_f, strips)
            adv = self.pool.advance(prog)
            died_pairs = list(zip(adv["died_clips"], adv["died_positions"]))
        self._release_died(died_pairs)
        self.clock.advance_block()
        self.total_blocks += 1
        return (BlockResult(outputs=outputs, midi_out=midi_out,
                            tick_count=tick_count), "per_block", 1)

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
        (lib/SamplerSynthVoice.cpp:264-267) and the clips' throttled
        progress and level callbacks, in one pass over the feedback table
        (models/feedback.FeedbackTable.update), and the block's meters to
        AudioLevels and any active disk recorders. Forces ONE device->host
        copy of the block's meter and peak tensors (fetch_session_arrays)
        unless the caller passes `fetched`; meters only need the
        reference's 50 ms cadence (lib/AudioLevels.cpp:325)."""
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
        self.feedback.update(self.pool, peaks)
