"""Python side of the port's C ABI: libzl_tpu/capi/bridge.py over the port.

The port's libzl.so (`_build.build_shim`: native/libzl_shim.cpp compiled
unchanged, its import pointed here) embeds CPython and calls this module's
functions by name. `init_engine` builds the singleton EngineRuntime — the
port's AudioEngine plus a pump thread that renders blocks paced to the wall
clock — and every other function is one C entry point.

Where it differs from the reference bridge:

- Device. LIBZL_TPU_BACKEND takes `cuda` (the default), `cuda:N` or `cpu`;
  anything else (the reference's auto, numpy or jax, or a typo) raises a
  ValueError naming the variable, and `cuda` without a card raises. Nothing
  picks the CPU by itself.
- Host copies. Every host consumer (the sink, the recorders, the capture
  meters, the session update) receives numpy float32, never a tensor. A
  block delivered on its own starts its device->host copy (the master mix;
  the session arrays on meter-cadence blocks; every output while recording)
  right after process_block returns, non-blocking into pinned memory, and
  delivery waits on that copy's CUDA event only. A blocking `.cpu()` issued
  when the block is consumed would wait for every block enqueued after it on
  the in-order stream, which defeats the pipeline.
- Bounce drain. K drained blocks' master mixes and session arrays go through
  one `torch.cat` on the device and the same kind of copy, which lands at the
  next flush. The reference's jit cache for that concat (`_flat_concat`) and
  its warmup (`_warm_drain_shapes`) existed to avoid XLA compiles mid
  performance; PyTorch compiles nothing here, so both are gone.
- Threads. The pump thread and `step_blocks` enter the engine's device (the
  current CUDA device is per thread).

The entry points that touch no runtime (clip properties and callbacks,
dBFromVolume, stopClips, the timer multiplier) and `_set_realtime_priority`
are copies of the reference's functions: they act on the port's own clip
registry (models/clip.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..constants import BEAT_SUBDIVISIONS, TICKS_PER_BAR
from ..device import device_from_env
from ..engine.render import RenderOutputs
from ..io.sinks import make_sink
from ..io.sources import make_source
from ..io.wav import read_audio
from ..models import clip as clip_mod
from ..models.clip import ClipAudioSource
from ..models.fader import fader_position_to_db
from ..utils.profiling import BlockProfiler

_PROGRESS_CB = ctypes.CFUNCTYPE(None, ctypes.c_float)
_LEVEL_CB = ctypes.CFUNCTYPE(None, ctypes.c_float)
_TIMER_CB = ctypes.CFUNCTYPE(None, ctypes.c_int)

def _set_realtime_priority() -> None:
    """Elevate the CALLING thread to SCHED_FIFO (the reference's RT tick
    thread runs SCHED_FIFO max priority, lib/SyncTimer.cpp:139-142). On
    Linux, sched_setscheduler(0, ...) applies to the calling thread, so
    the pump gets RT scheduling while the speculative sim/dispatch
    workers stay SCHED_OTHER — on few-core hosts the workers' native
    horizon sims and 0.6 MB payload packs otherwise timeslice-delay a
    ~0.05 ms emit block past its 2.67 ms budget (storm-soak slo_worst:
    7-8 ms emits at h_cursor 3, exactly the first spec-build blocks —
    NOTES round-5 campaign #5). Priority via LIBZL_TPU_RT_PRIORITY
    (default 10, 0 disables); EPERM (non-root, no CAP_SYS_NICE) is
    normal and silently ignored — behavior is then identical to before.
    """
    try:
        prio = int(os.environ.get("LIBZL_TPU_RT_PRIORITY", "10") or 0)
    except ValueError:
        prio = 0
    if prio <= 0 or not hasattr(os, "sched_setscheduler"):
        return
    try:
        os.sched_setscheduler(0, os.SCHED_FIFO, os.sched_param(prio))
    except (PermissionError, OSError, AttributeError):
        pass


class _HostCopy:
    """A device->host copy in flight: `tensors` raveled and concatenated on
    their device, then copied into pinned host memory without blocking the
    host; a CUDA event marks its end. `wait()` returns the flat float32
    array, waiting on that event only. On the CPU the concatenation is the
    copy."""

    def __init__(self, tensors, device: torch.device):
        self._event = None
        if device.type != "cuda":
            self._host = torch.cat([t.reshape(-1) for t in tensors])
            return
        with torch.cuda.device(device):
            flat = torch.cat([t.reshape(-1) for t in tensors])
            self._host = torch.empty(flat.shape, dtype=flat.dtype,
                                     pin_memory=True)
            self._host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _split_outputs(outputs, flat: np.ndarray):
    """RenderOutputs of numpy views into `flat`, which starts with every
    field of `outputs` raveled in field order; returns (outputs, offset of
    what follows)."""
    parts, off = [], 0
    for t in outputs:
        n = t.numel()
        parts.append(flat[off:off + n].reshape(tuple(t.shape)))
        off += n
    return RenderOutputs(*parts), off


@dataclasses.dataclass
class _Staged:
    """A block's host copy, started right after its render was enqueued."""

    copy: _HostCopy
    plan: Optional[tuple]   # session_fetch_plan on meter-cadence blocks
    outputs: bool           # every output field rides the copy (recording)


class EngineRuntime:
    """The process-wide engine singleton + block pump thread."""

    def __init__(self, sample_rate: int = 48000, block_frames: int = 128,
                 num_voices: int = 256, device: str = "cuda",
                 pipeline_depth: int = 1,
                 bounce_drain: "int | str" = "auto",
                 lookahead: "int | str" = "auto",
                 quirk_gain: bool = False):
        from ..engine.engine import AudioEngine

        self.engine = AudioEngine(
            device,
            sample_rate=sample_rate,
            block_frames=block_frames,
            num_voices=num_voices,
            lookahead=lookahead,
            quirk_gain=quirk_gain,
        )
        # blocks rendered before the host consumes the oldest: the pump
        # enqueues block n before it waits for block n-1's copy
        self.pipeline_depth = max(int(pipeline_depth), 0)
        # schedule-ahead tracks real output latency (render + pipeline)
        self.engine.output_latency_blocks = 1 + self.pipeline_depth
        # audio output sink (io/sinks): the system:playback_1/2 analog; the
        # pump writes every consumed block's master mix here, in order
        self.sink = None
        # audio input source (io/sources): the SystemCapture tap analog;
        # the pump pulls one block per cycle into the capture meters
        self.source = None
        # bounce drain: for NON-pacing sinks (file/null bounces) gather K
        # blocks' master mixes and make ONE device->host copy for them.
        # Global-playback recording rides the drain (its input IS the
        # fetched master); other per-block consumers (port/channel
        # recorders, capture sources, pacing sinks) get per-block delivery.
        # "auto" = 32 on "cuda", 1 on "cpu" (the reference's accelerator /
        # host split). A non-pacing consumer sees its audio <= 2K blocks
        # late (one window gathering, one in flight), never reordered.
        if bounce_drain == "auto":
            bounce_drain = 32 if self.engine.device.type == "cuda" else 1
        self.bounce_drain_blocks = max(int(bounce_drain), 1)
        self._drain_buf: list = []  # [(block_no, BlockResult)]
        # the in-flight drain: (buf, plans, _HostCopy), delivered at the
        # NEXT flush, so its copy overlaps a whole drain window of rendering
        self._pending_drain = None
        # serializes whole drain flushes: a demanded flush (set_sink on an
        # API thread) must not interleave its sink writes with a pipelined
        # flush the pump is mid-delivery on — batches must land in block
        # order. Ordering: _flush_lock is taken BEFORE self._lock, never
        # after.
        self._flush_lock = threading.Lock()
        # sinks/sources replaced while pumping await a safe close (set_sink)
        self._retired_io: list = []
        self._pump: Optional[threading.Thread] = None
        self._running = False
        # last per-block exception seen by the pump (see _run's guard)
        self.pump_error: Optional[BaseException] = None
        self._timer_callbacks: list = []
        self._cb_ticks = deque()  # ticks awaiting out-of-lock callback fan
        self.engine.timer_callbacks.append(self._fan_timer_callbacks)
        self._lock = threading.RLock()
        # pump phases (render, copy_wait, sink, session, sleep, flush_*):
        # cumulative seconds and counts (phase_stats) and each phase's
        # recent samples (profiler.summary(): p50/p90/p99/max)
        self._phase_s: dict = {}
        self._phase_n: dict = {}
        self.profiler = BlockProfiler()

    def run_locked(self, fn):
        """Run `fn()` under the engine lock — the public surface for
        external callers (CLI, embedding hosts) that must mutate engine
        state while the pump runs. Keeps the lock-ordering discipline
        (_flush_lock before _lock, never after) internal to this class."""
        with self._lock:
            return fn()

    def _phase(self, name: str, dt: float) -> None:
        self._phase_s[name] = self._phase_s.get(name, 0.0) + dt
        self._phase_n[name] = self._phase_n.get(name, 0) + 1
        self.profiler.record(name, dt)

    def phase_stats(self) -> dict:
        """Cumulative pump phase times (ms) and counts since boot."""
        out = {}
        for k in sorted(self._phase_s):
            out[k + "_ms"] = round(self._phase_s[k] * 1e3, 1)
            out[k + "_n"] = self._phase_n[k]
        return out

    # ------------------------------------------------------------- pumping

    def start_pump(self) -> None:
        if self._pump is not None:
            return
        # on the card, load the kernel library and render every (bucket,
        # rung, kind) the session can dispatch once — one horizon on the
        # spec dispatch thread — BEFORE going realtime (the initJuce-time
        # setup-cost analog, lib/libzl.cpp:358-410)
        if self.engine.device.type == "cuda":
            self.engine.warmup()
        # realtime GIL fairness: the speculative sim/dispatch workers run
        # Python stretches (torch op dispatch, numpy packing) that hold the
        # GIL for the full switch interval — at the 5 ms default a 2.67
        # ms-budget pump block can miss its deadline just waiting for the
        # interpreter (opt out: LIBZL_TPU_GIL_SWITCH_MS=0 keeps the
        # interpreter default)
        ms = os.environ.get("LIBZL_TPU_GIL_SWITCH_MS", "1")
        try:
            if float(ms) > 0:
                sys.setswitchinterval(float(ms) / 1e3)
        except ValueError:
            pass
        self._running = True
        self._pump = threading.Thread(target=self._run, daemon=True)
        self._pump.start()

    def stop_pump(self) -> None:
        self._running = False
        # local ref: the pump thread nulls self._pump on its own exit path
        # (_run's give-up tail), which can land between a check and a join
        p = self._pump
        if p is not None:
            p.join(timeout=5.0)
            self._pump = None

    def set_sink(self, sink) -> None:
        """Attach/replace the audio output sink (None detaches).

        Safe while the pump runs: the old sink is retired to the pump
        thread (its only user), which closes it at a safe point between
        blocks — closing here would race an in-flight blocking write."""
        # blocks drained for the OLD sink must land in it before the swap
        self._flush_drain()
        with self._lock:
            old, self.sink = self.sink, sink
            if old is not None:
                if self._pump is not None and self._running:
                    self._retired_io.append(old)
                    old = None
        if old is not None:
            old.close()

    def set_source(self, source) -> None:
        """Attach/replace the audio capture source (None detaches); same
        retirement discipline as set_sink. Attaching a source disables the
        bounce drain (per-block capture semantics) — flush first."""
        self._flush_drain()
        with self._lock:
            old, self.source = self.source, source
            if old is not None:
                if self._pump is not None and self._running:
                    self._retired_io.append(old)
                    old = None
        if old is not None:
            old.close()

    def _close_retired_io(self) -> None:
        """Pump-side: close sinks/sources retired by set_sink/set_source
        (no block is in flight on them once the pump reaches this point)."""
        with self._lock:
            retired, self._retired_io = self._retired_io, []
        for item in retired:
            try:
                item.close()
            except Exception:
                pass

    def _draining(self) -> bool:
        """The bounce drain takes the block: a non-pacing sink, no capture
        source, and no recorder but the global-playback one."""
        if self.bounce_drain_blocks <= 1:
            return False
        sink = self.sink
        levels = self.engine.levels
        return (sink is not None and not sink.pacing
                and self.source is None
                and (not levels.is_recording
                     or levels.only_global_recording()))

    def _stage(self, block_no: int, res) -> Optional[_Staged]:
        """Right after process_block, under the lock: start the host copy
        of a block that will be delivered on its own; None for a block the
        bounce drain will take."""
        if self._draining():
            return None
        return self._stage_copy(block_no, res)

    def _stage_copy(self, block_no: int, res) -> _Staged:
        """Start one block's host copy: its master mix (every output while
        recording) and, on a meter-cadence block, the session arrays
        (folding the peaks queued since the last one); other blocks queue
        their peaks. Under the lock, in block order. At a switch from
        drained to per-block delivery, the peaks of blocks still in the
        drain fold into the next cadence block's meters (meters only; the
        audio is unaffected)."""
        engine = self.engine
        outs = res.outputs
        full = engine.levels.is_recording
        parts = list(outs) if full else [outs.master]
        plan = None
        if block_no % engine._levels_every == 0:
            plan = engine.session_fetch_plan(res)
            parts += plan[0]
        else:
            engine.accumulate_peaks(res)
        return _Staged(_HostCopy(parts, engine.device), plan, full)

    def _consume(self, block_no: int, res,
                 staged: Optional[_Staged] = None) -> None:
        """Deliver one rendered block: the audio sink and recorders need
        every block; meters/positions only at the 50 ms analysis cadence.
        `staged` is the copy `_stage` started (None: the drain takes the
        block, or the copy starts here). The sink write happens OUTSIDE the
        engine lock: a pacing sink (ALSA PCM) blocks at the hardware rate
        and must not stall C-API calls."""
        engine = self.engine
        if self.bounce_drain_blocks > 1:
            if staged is None and self._draining():
                # under the lock: set_sink/set_source flush from API
                # threads, and a plain list swap can lose a concurrent
                # append
                with self._lock:
                    self._drain_buf.append((block_no, res))
                    full = (len(self._drain_buf)
                            >= self.bounce_drain_blocks)
                if full:
                    self._flush_drain_pipelined()
                return
            # per-block semantics resumed (recording started / sink
            # swapped): older drained blocks must land FIRST
            if self._drain_buf or self._pending_drain is not None:
                self._flush_drain()
        if staged is None:
            with self._lock:
                staged = self._stage_copy(block_no, res)
        t0 = time.perf_counter()
        flat = staged.copy.wait()
        self._phase("copy_wait", time.perf_counter() - t0)
        B = engine.block_frames
        outputs = None
        off = B * 2
        if staged.outputs:
            outputs, off = _split_outputs(res.outputs, flat)
        fetched = (staged.plan[1](flat, off) if staged.plan is not None
                   else None)
        sink = self.sink
        if sink is not None:
            t0 = time.perf_counter()
            sink.write(flat[:B * 2].reshape(B, 2))
            self._phase("sink", time.perf_counter() - t0)
        source = self.source
        capture = source.read(B) if source is not None else None
        t0 = time.perf_counter()
        with self._lock:
            if capture is not None:
                engine.levels.ingest_capture(capture)
            if engine.levels.is_recording:
                if outputs is None:
                    # recording began after the copy started
                    o = res.outputs
                    outputs, _ = _split_outputs(
                        o, _HostCopy(list(o), engine.device).wait())
                engine.levels.feed_recorders(outputs)
            if fetched is not None:
                engine.update_session(res, include_recorders=False,
                                      fetched=fetched)
        self._phase("session", time.perf_counter() - t0)

    def _plan_drain(self, buf) -> dict:
        """Walk drained blocks in order: accumulate_peaks queues skipped
        blocks' maxima so each cadence block's plan folds everything before
        it."""
        engine = self.engine
        t0 = time.perf_counter()
        plans = {}
        with self._lock:
            for i, (block_no, res) in enumerate(buf):
                if block_no % engine._levels_every == 0:
                    plans[i] = engine.session_fetch_plan(res)
                else:
                    engine.accumulate_peaks(res)
        self._phase("flush_plan", time.perf_counter() - t0)
        return plans

    def _drain_copy(self, buf, plans) -> _HostCopy:
        """Start ONE host copy of the drained blocks' master mixes plus
        every meter-cadence block's session arrays."""
        t0 = time.perf_counter()
        parts = [r.outputs.master for _, r in buf]
        for i in sorted(plans):
            parts.extend(plans[i][0])
        copy = _HostCopy(parts, self.engine.device)
        self._phase("flush_concat", time.perf_counter() - t0)
        return copy

    def _deliver_pending(self, pending) -> None:
        buf, plans, copy = pending
        t0 = time.perf_counter()
        flat = copy.wait()
        self._phase("flush_sync", time.perf_counter() - t0)
        self._deliver_drained(buf, plans, flat)

    def _complete_pending_drain(self) -> None:
        """Deliver the in-flight drain, if any."""
        with self._lock:
            pending, self._pending_drain = self._pending_drain, None
        if pending is not None:
            self._deliver_pending(pending)

    def _flush_drain_pipelined(self) -> None:
        """Pump-path flush: start the new batch's host copy, then deliver
        the PREVIOUS batch (whose copy has been in flight for a whole drain
        window). Costs one drain window of delivery latency — free on the
        non-pacing bounce sinks drains engage on."""
        with self._flush_lock:
            with self._lock:
                buf, self._drain_buf = self._drain_buf, []
            if not buf:
                self._complete_pending_drain()
                return
            plans = self._plan_drain(buf)
            copy = self._drain_copy(buf, plans)
            with self._lock:
                prev = self._pending_drain
                self._pending_drain = (buf, plans, copy)
            if prev is not None:
                self._deliver_pending(prev)

    def _flush_drain(self) -> None:
        """Demanded flush (sink/source swaps, record toggles, pump stop,
        step_blocks): deliver EVERYTHING — the in-flight drain first (older
        blocks), then the current buffer through one host copy."""
        with self._flush_lock:
            self._complete_pending_drain()
            with self._lock:
                buf, self._drain_buf = self._drain_buf, []
            if buf:
                plans = self._plan_drain(buf)
                self._deliver_pending((buf, plans,
                                       self._drain_copy(buf, plans)))

    def _deliver_drained(self, buf, plans, flat) -> None:
        engine = self.engine
        B = engine.block_frames
        t0 = time.perf_counter()
        n_master = B * 2
        big = flat[: n_master * len(buf)].reshape(len(buf) * B, 2)
        off = n_master * len(buf)
        fetched = {}
        for i in sorted(plans):
            _, unpack, total = plans[i]
            fetched[i] = unpack(flat, off)
            off += total
        sink = self.sink
        for i, (block_no, res) in enumerate(buf):
            blk = big[i * B:(i + 1) * B]
            if sink is not None:
                sink.write(blk)
            with self._lock:
                levels = engine.levels
                if levels.is_recording and levels.only_global_recording():
                    # the global recorder's input IS the fetched master —
                    # feed it from the batch, no extra copy
                    levels.feed_global_recorder(blk)
                if i in fetched:
                    engine.update_session(res, include_recorders=False,
                                          fetched=fetched[i])
        self._phase("flush_deliver", time.perf_counter() - t0)

    def step_blocks(self, n: int) -> None:
        """Deterministic pump: render and consume `n` blocks synchronously.
        Drives the exact per-block delivery path the wall-clock pump uses
        (sink, recorders, meter cadence) without any timing dependence —
        for tests and offline bounces under LIBZL_TPU_NO_PUMP."""
        if self._pump is not None:
            raise RuntimeError("step_blocks requires the pump to be stopped")
        engine = self.engine
        with engine._on_device():
            for _ in range(int(n)):
                with self._lock:
                    res = engine.process_block()
                    block_no = engine.total_blocks
                    staged = self._stage(block_no, res)
                self._consume(block_no, res, staged)
                self._fire_timer_callbacks()
            self._flush_drain()

    def run_ahead_blocks(self) -> int:
        """The pump's wall-clock run-ahead margin in blocks. Must cover
        the lookahead horizon: a horizon-build / adoption block
        legitimately delivers H blocks in one call (its SLO budget is H
        periods), so the pump keeps at least H+2 blocks of slack."""
        la = getattr(self.engine, "_lookahead", 0)
        return max(4, 2 * (self.pipeline_depth + 1), la + 2)

    def _run(self) -> None:
        """Render paced to the wall clock, a few blocks ahead (the JACK
        period callback + latency analog)."""
        _set_realtime_priority()
        with self.engine._on_device():
            self._pump_blocks()
        # a give-up exit (100 consecutive failures) must not leave the
        # runtime looking alive: _running=True would make start_pump a
        # silent no-op and route retired sinks/sources to a dead drainer
        self._running = False
        self._pump = None

    def _pump_blocks(self) -> None:
        engine = self.engine
        spb = engine.block_frames / engine.sample_rate
        depth = self.pipeline_depth
        ahead = self.run_ahead_blocks() * spb
        start = time.monotonic()
        rendered = 0.0
        # pipelined dispatch: keep up to `depth` blocks in flight and
        # consume the oldest only after enqueueing the newest, so its host
        # copy overlaps the device rendering ahead
        inflight: deque = deque()  # (block_no, BlockResult, _Staged|None)
        consecutive_errors = 0
        while self._running:
            # a pacing sink (ALSA PCM) blocks in write() at the hardware
            # rate — it IS the clock; only pace on the wall clock without
            sink = self.sink
            if sink is None or not sink.pacing:
                now = time.monotonic() - start
                if rendered - now > ahead:
                    t0 = time.perf_counter()
                    time.sleep(spb / 2)
                    self._phase("sleep", time.perf_counter() - t0)
                    continue
            # per-block exception guard: a bad record-port name or malformed
            # command must not silently kill audio forever. Record, keep
            # pumping; give up only after sustained failure.
            try:
                t0 = time.perf_counter()
                with self._lock:
                    res = engine.process_block()
                    block_no = engine.total_blocks
                    inflight.append(
                        (block_no, res, self._stage(block_no, res)))
                self._phase("render", time.perf_counter() - t0)
                while len(inflight) > depth:
                    self._consume(*inflight.popleft())
                self._fire_timer_callbacks()  # outside self._lock
                consecutive_errors = 0
            except Exception as e:  # noqa: BLE001 — the guard IS the point
                self.pump_error = e
                consecutive_errors += 1
                if consecutive_errors == 1:
                    print("libzl_tpu_torch pump: block failed (continuing):",
                          file=sys.stderr)
                    traceback.print_exc()
                if consecutive_errors >= 100:
                    print("libzl_tpu_torch pump: 100 consecutive block "
                          "failures, stopping", file=sys.stderr)
                    break
                time.sleep(spb)
            if self._retired_io:
                self._close_retired_io()
            # hardware MIDI discovery on the reference's 300 ms connector
            # cadence: the blocking enumeration runs with NO lock held; only
            # the cheap diff/open/close applies under the lock
            router = engine.router
            if router.auto_discover and router.scanner.due():
                hints = router.scanner.scan_hints()
                if hints is not None:
                    with self._lock:
                        router.scanner.apply(hints)
            rendered += spb
        # drain in-flight blocks so sink/recorders keep the final audio
        while inflight:
            try:
                self._consume(*inflight.popleft())
            except Exception:
                pass
        try:
            self._fire_timer_callbacks()
        except Exception:
            pass
        try:
            self._flush_drain()
        except Exception:
            pass
        self._close_retired_io()

    def _fan_timer_callbacks(self, tick: int) -> None:
        """Engine-side hook: fires INSIDE process_block, i.e. under
        self._lock on the pump thread. C timer callbacks may re-enter the
        API — including flushing calls whose _flush_lock must never be
        taken after self._lock — so the client callbacks are deferred to
        _fire_timer_callbacks, which runs OUTSIDE the lock."""
        self._cb_ticks.append(int(tick))

    def _fire_timer_callbacks(self) -> None:
        while self._cb_ticks:
            tick = self._cb_ticks.popleft()
            for cb in list(self._timer_callbacks):
                cb(tick)


_runtime: Optional[EngineRuntime] = None


def _rt() -> EngineRuntime:
    if _runtime is None:
        raise RuntimeError("initJuce() has not been called")
    return _runtime


# ---------------------------------------------------------------- lifecycle

def init_engine(sample_rate: int = 48000, block_frames: int = 128,
                num_voices: int = 256, device: str = "cuda",
                pump: bool = True) -> None:
    """initJuce (lib/libzl.cpp:358-410): construct the engine singletons.

    Env overrides for embedding hosts (no Python API available there):
    LIBZL_TPU_BACKEND=cuda|cuda:N|cpu (the device; default cuda),
    LIBZL_TPU_VOICES, LIBZL_TPU_BLOCK, LIBZL_TPU_RATE, LIBZL_TPU_NO_PUMP=1,
    LIBZL_TPU_PIPELINE=<depth>, LIBZL_TPU_BOUNCE_DRAIN=<K> (non-pacing
    sinks: one device->host copy per K blocks), LIBZL_TPU_LOOKAHEAD=<H>
    (horizon depth; "auto" fills a 2048-frame window),
    LIBZL_TPU_SINK=alsa[:dev]|file:path|null,
    LIBZL_TPU_SOURCE=alsa[:dev]|file:path|null, LIBZL_TPU_WARMUP=1 (render
    every shape the session can dispatch before the pump starts; on cuda
    the pump's start does it anyway), LIBZL_TPU_QUIRK_GAIN=1
    (strict-reference audio, lib/SamplerSynthVoice.cpp:204-205).
    """
    global _runtime
    if _runtime is None:
        device = device_from_env(device)
        num_voices = int(os.environ.get("LIBZL_TPU_VOICES", num_voices))
        block_frames = int(os.environ.get("LIBZL_TPU_BLOCK", block_frames))
        sample_rate = int(os.environ.get("LIBZL_TPU_RATE", sample_rate))
        depth = int(os.environ.get("LIBZL_TPU_PIPELINE", 1))
        drain = os.environ.get("LIBZL_TPU_BOUNCE_DRAIN", "auto")
        if drain != "auto":
            drain = int(drain)
        la = os.environ.get("LIBZL_TPU_LOOKAHEAD", "auto")
        if la != "auto":
            la = int(la)
        if os.environ.get("LIBZL_TPU_NO_PUMP"):
            pump = False
        # build fully before publishing the singleton: a bad sink/source
        # spec must raise WITHOUT leaving a half-initialized, pump-less
        # engine behind (a retry would then silently no-op)
        runtime = EngineRuntime(sample_rate, block_frames, num_voices, device,
                                pipeline_depth=depth, bounce_drain=drain,
                                lookahead=la,
                                quirk_gain=bool(
                                    os.environ.get("LIBZL_TPU_QUIRK_GAIN")))
        try:
            sink_spec = os.environ.get("LIBZL_TPU_SINK")
            if sink_spec:
                runtime.set_sink(make_sink(sink_spec, sample_rate))
            source_spec = os.environ.get("LIBZL_TPU_SOURCE")
            if source_spec:
                runtime.set_source(make_source(source_spec, sample_rate))
        except Exception:
            # a bad source spec must not leak the already-attached sink
            runtime.set_sink(None)
            runtime.set_source(None)
            raise
        _runtime = runtime
        if os.environ.get("LIBZL_TPU_WARMUP"):
            runtime.engine.warmup()
        if pump:
            _runtime.start_pump()


def shutdown_engine() -> None:
    """shutdownJuce (lib/libzl.cpp:412-415)."""
    global _runtime
    if _runtime is not None:
        _runtime.stop_pump()
        _runtime.set_sink(None)
        _runtime.set_source(None)
        _runtime = None
        # the clip registry is process-global: stale entries would resolve
        # old ids to clips bound to the DEAD engine after a re-init
        for c in list(clip_mod._registry.values()):
            c.pending_file = False  # cancel file watchers
        clip_mod._registry.clear()


def reload_zynthian_configuration() -> None:
    """reloadZynthianConfiguration (lib/libzl.cpp:417-419)."""
    _rt().engine.router.reload_configuration()


def db_from_volume(vol: float) -> float:
    """dBFromVolume (lib/libzl.cpp:429)."""
    return fader_position_to_db(vol)


def stop_clips(clip_ids: list[int]) -> None:
    """stopClips (lib/libzl.cpp:441-449)."""
    for cid in clip_ids:
        clip = clip_mod.clip_by_id(cid)
        if clip is not None:
            clip.stop(-3)


# ------------------------------------------------------- ClipAudioSource API

def clip_new(filepath: str, muted: bool = False) -> int:
    rt = _rt()
    # decode OUTSIDE the engine lock: a long FLAC/MP3 load must not stall
    # the pump past its schedule-ahead; only the registration needs it
    if not os.path.exists(filepath):
        # a not-yet-written sample file plays a silent placeholder until a
        # 100 ms poll loads it (lib/SamplerSynthSound.cpp:55-58)
        with rt._lock:
            clip = ClipAudioSource(rt.engine, filepath=str(filepath),
                                   muted=muted, wait_for_file=True)
        return clip.id
    audio = read_audio(filepath)
    with rt._lock:
        clip = ClipAudioSource(rt.engine, audio=audio, muted=muted)
        clip.filepath = str(filepath)
    return clip.id


def clip_by_id(clip_id: int):
    return clip_mod.clip_by_id(clip_id)


def _clip(clip_id: int):
    clip = clip_by_id(clip_id)
    if clip is None:
        raise KeyError(f"no clip with id {clip_id}")
    return clip


def clip_destroy(clip_id: int) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).destroy()


def clip_play(clip_id: int, loop: bool, midi_channel: int = -2) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).play(loop, midi_channel)


def clip_stop(clip_id: int, midi_channel: int = -2) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).stop(midi_channel)


def clip_get_duration(clip_id: int) -> float:
    return _clip(clip_id).get_duration()


def clip_get_filename(clip_id: int) -> str:
    return os.path.basename(_clip(clip_id).filepath)


def clip_set_start_position(clip_id: int, seconds: float) -> None:
    _clip(clip_id).set_start_position(seconds)


def clip_set_length(clip_id: int, beat: float, bpm: int) -> None:
    _clip(clip_id).set_length(beat, bpm)


def clip_set_pan(clip_id: int, pan: float) -> None:
    _clip(clip_id).set_pan(pan)


# speed/pitch/gain/crossfade: DEFERRED + under the runtime lock — the
# re-render runs on the worker and swaps at a block boundary inside
# process_block (a synchronous re-render on the API thread would race the
# pump's pool mutations)

def clip_set_speed_ratio(clip_id: int, ratio: float) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_speed_ratio(ratio, defer=True)


def clip_set_pitch(clip_id: int, semitones: float) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_pitch(semitones, defer=True)


def clip_set_gain(clip_id: int, db: float) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_gain(db, defer=True)


def clip_set_loop_crossfade(clip_id: int, seconds: float) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_loop_crossfade(seconds, defer=True)


def clip_set_volume(clip_id: int, vol: float) -> None:
    _clip(clip_id).set_volume(vol)


def clip_set_slices(clip_id: int, count: int) -> None:
    _clip(clip_id).set_slices(count)


def clip_keyzone_start(clip_id: int) -> int:
    return _clip(clip_id).keyzone_start


def clip_set_keyzone_start(clip_id: int, v: int) -> None:
    _clip(clip_id).keyzone_start = int(v)


def clip_keyzone_end(clip_id: int) -> int:
    return _clip(clip_id).keyzone_end


def clip_set_keyzone_end(clip_id: int, v: int) -> None:
    _clip(clip_id).keyzone_end = int(v)


def clip_root_note(clip_id: int) -> int:
    return _clip(clip_id).root_note


def clip_set_root_note(clip_id: int, v: int) -> None:
    _clip(clip_id).root_note = int(v)


def clip_adsr_attack(clip_id: int) -> float:
    return _clip(clip_id).adsr_attack


def clip_set_adsr_attack(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_attack = float(v)


def clip_adsr_decay(clip_id: int) -> float:
    return _clip(clip_id).adsr_decay


def clip_set_adsr_decay(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_decay = float(v)


def clip_adsr_sustain(clip_id: int) -> float:
    return _clip(clip_id).adsr_sustain


def clip_set_adsr_sustain(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_sustain = float(v)


def clip_adsr_release(clip_id: int) -> float:
    return _clip(clip_id).adsr_release


def clip_set_adsr_release(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_release = float(v)


def clip_set_progress_callback(clip_id: int, fn_ptr: int) -> None:
    cb = _PROGRESS_CB(fn_ptr)
    _clip(clip_id).progress_callback = lambda v: cb(float(v))


def clip_set_audio_level_callback(clip_id: int, fn_ptr: int) -> None:
    cb = _LEVEL_CB(fn_ptr)
    _clip(clip_id).audio_level_callback = lambda v: cb(float(v))


# -------------------------------------------------------------- SyncTimer API

def timer_start(bpm: int) -> None:
    """SyncTimer_startTimer: the argument is a BPM, as in the reference
    (lib/SyncTimer.cpp:869-872). Under the runtime lock: a transport
    mutation preempts the lookahead horizon, which must not race the
    pump's process_block."""
    rt = _rt()
    with rt._lock:
        rt.engine.start_transport(bpm=max(int(bpm), 1))


def timer_stop() -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.stop_transport()


def timer_set_bpm(bpm: float) -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.set_bpm(bpm)


def timer_get_multiplier() -> int:
    return BEAT_SUBDIVISIONS


def timer_register_callback(fn_ptr: int) -> None:
    """The reference hands callbacks the tick-within-bar, wrapping at
    BeatSubdivisions*4 = 384 (lib/SyncTimer.cpp:397-409)."""
    rt = _rt()
    cb = _TIMER_CB(fn_ptr)
    wrapper = lambda tick: cb(int(tick % TICKS_PER_BAR))  # noqa: E731
    wrapper._fn_ptr = fn_ptr
    rt._timer_callbacks.append(wrapper)


def timer_deregister_callback(fn_ptr: int) -> None:
    rt = _rt()
    rt._timer_callbacks = [
        cb for cb in rt._timer_callbacks
        if getattr(cb, "_fn_ptr", None) != fn_ptr
    ]


def timer_queue_clip_to_start(clip_id: int, midi_channel: int = -1) -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.queue_clip_to_start(_clip(clip_id), midi_channel)


def timer_queue_clip_to_stop(clip_id: int, midi_channel: int = -1) -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.queue_clip_to_stop(_clip(clip_id), midi_channel)


# ------------------------------------------------------------ AudioLevels API

def levels_is_recording() -> bool:
    return _rt().engine.levels.is_recording


def levels_set_record_global_playback(should: bool) -> None:
    _rt().engine.levels.set_record_global_playback(should)


def levels_set_global_playback_filename_prefix(prefix: str) -> None:
    _rt().engine.levels.set_global_playback_filename_prefix(prefix)


def levels_start_recording() -> None:
    rt = _rt()
    # blocks drained BEFORE the toggle belong to the pre-record stream:
    # flush them so the recorder starts at the toggle boundary (blocks in
    # the pump's pipeline, <= its depth, may still land on either side)
    rt._flush_drain()
    rt.run_locked(rt.engine.levels.start_recording)


def levels_stop_recording() -> None:
    rt = _rt()
    # drained blocks rendered while recording must reach the recorder
    # before it closes
    rt._flush_drain()
    rt.run_locked(rt.engine.levels.stop_recording)


def levels_set_record_ports_filename_prefix(prefix: str) -> None:
    _rt().engine.levels.set_record_ports_filename_prefix(prefix)


def levels_add_record_port(port: str, channel: int) -> None:
    _rt().engine.levels.add_record_port(port, channel)


def levels_remove_record_port(port: str, channel: int) -> None:
    _rt().engine.levels.remove_record_port(port, channel)


def levels_clear_record_ports() -> None:
    _rt().engine.levels.clear_record_ports()


def levels_set_should_record_ports(should: bool) -> None:
    _rt().engine.levels.set_should_record_ports(should)


# -------------------------------------------------------- JackPassthrough API

_STRIP_KEYS = {"pan": "pan", "dry": "dry", "wet1": "wet1", "wet2": "wet2",
               "muted": "muted"}


def passthrough_set(channel: int, key: str, value: float) -> None:
    _rt().engine.set_strip(channel, **{_STRIP_KEYS[key]: value})


def passthrough_get(channel: int, key: str) -> float:
    return _rt().engine.get_strip(channel, _STRIP_KEYS[key])
