"""Engine benchmark of the PyTorch/CUDA port: the north-star session.

    python -m libzl_tpu_torch.bench [--device cuda:0|cpu] [--quick]

The counterpart of the reference's bench.py. Renders the full engine
pipeline (1024 sampler voices over 64 looped clips across 10 channels at
48 kHz) through the engine's default options on the named device (default
the first card; there is no "cuda if available" picker) and reports:

- throughput: 1024-frame superblocks, blocks chained with one device sync a
  round, the median round's realtime factor (`value`, `rt_superblock`), the
  best round and every round;
- live play: 128-frame blocks chained (`rt_liveblock`; `device_ms_p50` is the
  best round's HOST WALL ms a block in that chained regime, the reference's
  key, not a device time), synced every block (`latency_p50_ms`,
  `latency_mean_ms`; `sync_ms_p50` is the sync call's own time), and 32
  blocks' masters drained through one torch.cat and one copy
  (`bounce_ms_per_block`; `bounce_sync_amortization` is the synced loop's
  mean over it: the p50s would set an emitted slice against a horizon
  build);
- the render alone: one real program of the live session, on the device
  once, re-enqueued: host wall ms a render (`kernel_host_ms_p50`, what the
  reference's cell reads), device ms a render from CUDA events with the
  enqueue hidden behind a spin (`kernel_ms_p50`), and the same loop over one
  trivial op (`dispatch_floor_ms`), so launch time is not read as kernel
  time;
- the five hand-written kernels on that program's inputs, CUDA events with
  the L2 flushed: `voice_prep_kernel_ms`, `fetch_kernel_ms`,
  `voice_post_kernel_ms`, `mixdown_kernel_ms`, `finish_kernel_ms`, beside
  `kernel_bound_ms`, the sum of their bounds (utils/roofline);
  `kernel_pct_of_bound` is that bound over the kernels' time (never over
  100), `pct_of_bound` the bound over `device_ms_p50` (the reference's
  meaning: the rest is host build, upload and dispatch);
- 96 voices at B=1024 (`realtime_factor_96voices`) and 96 live voices on the
  1024-voice pool with voice buckets at B=128
  (`rt_liveblock_96on1024_bucketed`);
- the superblocks through the lookahead horizon at H=2, the reference's
  default there, beside the headline's default engine
  (`rt_superblock_lookahead2`, best round);
- the superblock realtime of the per-block engine on a mesh of k shards of
  the one device, warmed, replaying its render graphs (one CUDA graph a
  render, as on one shard) (`rt_superblock_mesh_k2`, `_k4`);
- the C ABI's wall-clock pump at B=128 with a null sink: blocks rendered
  over block periods of wall time (`pump_realtime_share`; 1.0 is realtime).

Prints ONE JSON line on stdout; progress goes to stderr. The run budgets
itself: `LIBZL_BENCH_BUDGET_S` (default 600 s) bounds the wall time, cells
that no longer fit are skipped, and a watchdog prints the line from the
cells that completed (missing cells -1, "partial": true) and exits 0 if the
deadline arrives mid-cell. A cell that raises is noted on stderr, stays -1,
and the run exits 1 after the line is printed. "device" is the card's name
and power limit as nvidia-smi gives them, or "cpu"; on the CPU every time is
the host clock's and the kernels are their plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

NUM_VOICES = 1024
NUM_CLIPS = 64
SAMPLE_RATE = 48000
SUPER_BLOCK = 1024
LIVE_BLOCK = 128

DEFAULT_BUDGET_S = 600.0
# wall margin the watchdog keeps for printing and teardown
WATCHDOG_MARGIN_S = 10.0

# block and round counts of each cell: the full run and a short one
FULL = dict(throughput=(9, 80), live_blocks=300, drain=(32, 10),
            resident=(5, 32), headline_blocks=400, sparse_blocks=200,
            mesh_blocks=40, pump_seconds=5.0)
QUICK = dict(throughput=(3, 20), live_blocks=100, drain=(32, 3),
             resident=(3, 8), headline_blocks=80, sparse_blocks=80,
             mesh_blocks=10, pump_seconds=2.0)
MESH_SHARDS = (2, 4)

# the line's numeric cells, -1 until measured
CELLS = (
    "rt_liveblock", "device_ms_p50", "latency_p50_ms", "latency_mean_ms",
    "sync_ms_p50", "bounce_ms_per_block", "bounce_sync_amortization",
    "kernel_ms_p50", "kernel_host_ms_p50", "dispatch_floor_ms",
    "fetch_kernel_ms", "mixdown_kernel_ms", "voice_prep_kernel_ms",
    "voice_post_kernel_ms", "finish_kernel_ms", "kernel_bound_ms",
    "pct_of_bound",
    "kernel_pct_of_bound", "realtime_factor_96voices",
    "rt_liveblock_96on1024_bucketed", "rt_superblock_lookahead2",
    *(f"rt_superblock_mesh_k{k}" for k in MESH_SHARDS),
    "pump_realtime_share", "fence_seconds",
)


# ------------------------------------------------------------ the session


def session_plan(sr: int, num_voices: int = NUM_VOICES,
                 num_clips: int = NUM_CLIPS):
    """The benchmark's session, drawn from seed 0 as the reference draws it:
    `num_clips` two-partial sine clips of 0.4-2 s ([T, 1] f32) and one
    looped ClipCommand per voice across 10 channels, as
    `make_command(clip_id)` callables."""
    from .engine.commands import ClipCommand

    rng = np.random.default_rng(0)
    waves = []
    for i in range(num_clips):
        seconds = float(rng.uniform(0.4, 2.0))
        t = np.arange(int(sr * seconds)) / sr
        freq = 110.0 * (2.0 ** (i % 24 / 12.0))
        waves.append((
            0.25 * np.sin(2 * np.pi * freq * t)
            + 0.1 * np.sin(2 * np.pi * 2 * freq * t)
        ).astype(np.float32)[:, None])
    voices = []
    for v in range(num_voices):
        # distinct notes per (clip, channel) pair so no commands coalesce
        note = 48 + (v // 320) * 5 + int(rng.integers(0, 5))
        volume = float(rng.uniform(0.3, 1.0))

        def make_command(clip_id, v=v, note=note, volume=volume):
            cmd = ClipCommand.channel(clip_id, v % 10)
            cmd.midi_note = note
            cmd.change_volume = True
            cmd.volume = volume
            cmd.looping = True
            cmd.start_playback = True
            return cmd

        voices.append((v % num_clips, make_command))
    return waves, voices


def populate_session(engine, num_voices: int = NUM_VOICES,
                     num_clips: int = NUM_CLIPS):
    """session_plan's clips and `num_voices` voices on a given engine, the
    transport started at 120 BPM. Returns the clips."""
    from .io.wav import AudioData
    from .models.clip import ClipAudioSource

    sr = engine.sample_rate
    engine.start_transport(bpm=120)
    waves, voices = session_plan(sr, num_voices, num_clips)
    clips = [ClipAudioSource(engine, audio=AudioData(w, sr)) for w in waves]
    for i, make_command in voices:
        engine.schedule_clip_command(make_command(clips[i].id), 0)
    return clips


def build_session(block_frames: int, num_voices: int = NUM_VOICES,
                  active_voices: int = 0, device="cuda:0",
                  num_clips: int = NUM_CLIPS, **options):
    """The reference's build_session: an engine of `num_voices` voices on
    `device` with the session's first `active_voices` (default all) voices
    playing. `options` go to AudioEngine."""
    from .engine.engine import AudioEngine

    engine = AudioEngine(device, sample_rate=SAMPLE_RATE,
                         block_frames=block_frames, num_voices=num_voices,
                         **options)
    populate_session(engine, active_voices or num_voices, num_clips)
    return engine


# ---------------------------------------------------------------- a run


class Run:
    """One run's device, session size, deadline and results."""

    def __init__(self, device="cuda:0", budget_s: float = DEFAULT_BUDGET_S,
                 num_voices: int = NUM_VOICES, num_clips: int = NUM_CLIPS,
                 reserve_s: float = 20.0):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.num_voices = num_voices
        self.num_clips = num_clips
        # a cell starts only while more than this is left of the budget
        self.reserve_s = reserve_s
        self.budget_s = budget_s
        self.start = time.monotonic()
        self.deadline = self.start + budget_s
        self.results: dict = {}
        self.failed: list = []
        self.skipped: list = []
        self._lock = threading.Lock()
        self._printed = threading.Event()

    def remaining(self) -> float:
        return self.deadline - time.monotonic()

    def note(self, msg: str) -> None:
        """Progress and diagnostics: stderr only."""
        print(f"[bench +{time.monotonic() - self.start:.0f}s] {msg}",
              file=sys.stderr, flush=True)

    def set(self, **kv) -> None:
        with self._lock:
            self.results.update(kv)

    def get(self, key: str, default=-1.0):
        with self._lock:
            return self.results.get(key, default)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def session(self, block_frames: int, num_voices: int = 0,
                active_voices: int = 0, **options):
        """build_session on this run's device, warmed up. The fetch is the
        windows fetch on either device (what a card's engine resolves to;
        on the CPU its plain version)."""
        options.setdefault("fetch", "windows")
        engine = build_session(block_frames, num_voices or self.num_voices,
                               active_voices, device=self.device,
                               num_clips=self.num_clips, **options)
        engine.warmup()
        return engine

    def line(self, partial: bool) -> dict:
        """The result line from the cells measured so far."""
        with self._lock:
            r = dict(self.results)
        active = int(r.pop("_active", self.num_voices))
        rt = float(r.pop("_rt_superblock", -1.0))
        rounds = r.pop("_rounds", [])
        out = {
            "metric": (f"realtime_factor_{active}voices_"
                       f"{self.num_clips}clips_48k"),
            "value": rt,
            "unit": "x_realtime",
            "vs_baseline": rt * active / 96.0 if rt > 0 else -1.0,
            "rt_superblock": rt,
            "rt_superblock_best": float(np.max(rounds)) if rounds else -1.0,
            "rt_superblock_rounds": rounds,
        }
        out.update({k: -1.0 for k in CELLS})
        out["device"] = "not read"
        out.update(r)
        if partial or self.skipped:
            out["partial"] = True
        return out

    def emit(self, partial: bool) -> None:
        """Print the one JSON line exactly once (the watchdog and the normal
        path race at the deadline)."""
        if self._printed.is_set():
            return
        self._printed.set()
        sys.stdout.write(json.dumps(self.line(partial)) + "\n")
        sys.stdout.flush()


def device_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _drive(engine, n: int):
    last = None
    for _ in range(n):
        last = engine.process_block()
    return last


def _host_ms(fn, iters: int) -> list:
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def events_ms(fn, iters: int, primed: bool, flush_l2: bool = True) -> list:
    """Per-call ms over CUDA events, one event pair per call, with the 50 MB
    L2 flushed before each call (the render's other tensors evict a kernel's
    inputs between its calls; `flush_l2` False leaves the last call's inputs
    there). `primed` queues a ~2.5 ms device spin after the flush, so the
    host enqueues the call while the card is busy and the pair brackets
    device execution only; unprimed, the pair also holds the host's launch
    latency (the card idles while the host launches)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush_l2:
            flush.zero_()
        if primed:
            torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def capture_calls(fn) -> dict:
    """Run `fn()` (a render, or an engine's process_block); the arguments of
    each kernel call it made (one a shard under a mesh, the finish one a
    render): {"fetch": [(args, r_max)], "mixdown": [(contrib, lane, init)],
    "voice_prep": [(prog, block_frames, max_pitch_ratio)], "voice_post":
    [(interp, g, valid, pan)], "finish": [(lane_mix, strips_packed)]}."""
    from .ops import finish, voice
    from .parallel import sharding

    calls = {"fetch": [], "mixdown": [], "voice_prep": [], "voice_post": [],
             "finish": []}
    real = {"fetch": voice.fetch_interp, "mixdown": sharding.lane_mixdown,
            "voice_prep": voice.voice_prep, "voice_post": voice.voice_post,
            "finish": finish.finish}

    def fetch(*args, **kw):
        calls["fetch"].append((args, kw.get("r_max", 4.0)))
        return real["fetch"](*args, **kw)

    def mix(contrib, lane, num_lanes=12, init=None):
        calls["mixdown"].append((contrib, lane, init))
        return real["mixdown"](contrib, lane, num_lanes, init)

    def prep(prog, block_frames, max_pitch_ratio=4.0):
        calls["voice_prep"].append((prog, block_frames, max_pitch_ratio))
        return real["voice_prep"](prog, block_frames, max_pitch_ratio)

    def post(interp, g, valid, pan, out=None):
        calls["voice_post"].append((interp, g, valid, pan))
        return real["voice_post"](interp, g, valid, pan, out=out)

    def fin(lane_mix, strips_packed):
        calls["finish"].append((lane_mix, strips_packed))
        return real["finish"](lane_mix, strips_packed)

    voice.fetch_interp, sharding.lane_mixdown = fetch, mix
    voice.voice_prep, voice.voice_post, finish.finish = prep, post, fin
    try:
        fn()
    finally:
        voice.fetch_interp, sharding.lane_mixdown = real["fetch"], \
            real["mixdown"]
        voice.voice_prep, voice.voice_post = real["voice_prep"], \
            real["voice_post"]
        finish.finish = real["finish"]
    return calls


def chained_realtime(engine, n: int) -> dict:
    """Realtime factor over `n` chained blocks (one copy of the last master
    to the host at the end) and the process_block p50 of those blocks."""
    from .utils.profiling import BlockProfiler

    engine.profiler = BlockProfiler()
    t0 = time.perf_counter()
    out = _drive(engine, n)
    out.outputs.master.cpu()
    wall = time.perf_counter() - t0
    engine.drain_speculation()
    return {"rt": n * engine.block_frames / engine.sample_rate / wall,
            "ms_p50": engine.profiler.summary()["process_block"]["p50_ms"]}


# ---------------------------------------------------------------- cells


def fence(run: Run) -> float:
    """The one-time costs outside every timed region: the CUDA context, the
    kernels' build and load, a first device-to-host copy. Seconds."""
    t0 = time.perf_counter()
    if run.cuda:
        from . import _build

        _build.load()
    (torch.ones(8, device=run.device) + 1).cpu()
    run.sync()
    return time.perf_counter() - t0


def measure_throughput(run: Run, rounds: int = 9,
                       blocks_per_round: int = 80) -> tuple:
    """Sustained throughput: `rounds` timed rounds of chained superblocks on
    one warm engine, one sync at the end of a round. Returns (median round's
    realtime factor, active voices, every round). The median tolerates a
    round the host's other tenants slowed; the best round and the band go
    into the line beside it. Rounds stop early when the budget runs low."""
    engine = run.session(SUPER_BLOCK)
    _drive(engine, 10)
    run.sync()
    active = int(engine.pool.active.sum())
    rendered = blocks_per_round * SUPER_BLOCK / SAMPLE_RATE
    rts = []
    for i in range(rounds):
        t0 = time.perf_counter()
        _drive(engine, blocks_per_round)
        run.sync()
        elapsed = time.perf_counter() - t0
        rts.append(rendered / elapsed)
        if i + 1 < rounds and run.remaining() < elapsed * 2 + run.reserve_s:
            run.note(f"throughput: stopping after {i + 1}/{rounds} rounds "
                     "(budget)")
            break
    engine.drain_speculation()
    return float(np.median(rts)), active, rts


def measure_live_mode(run: Run, blocks: int = 300, drain: tuple = (32, 10),
                      resident: tuple = (5, 32)) -> dict:
    """The live-play configuration (128-frame blocks): chained, synced every
    block, drained `drain[0]` blocks at a time, then the render alone and the
    kernels' roofline on one program of this engine (see the module's
    docstring for each key)."""
    engine = run.session(LIVE_BLOCK)
    _drive(engine, 20)
    run.sync()

    # chained: one sync per round, best of 5 rounds
    per_round = max(blocks // 5, 1)
    round_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        _drive(engine, per_round)
        run.sync()
        round_ms.append((time.perf_counter() - t0) / per_round * 1e3)
    device_ms = min(round_ms)
    run.set(rt_liveblock=LIVE_BLOCK / SAMPLE_RATE / (device_ms * 1e-3),
            device_ms_p50=device_ms)

    # synced: wait for the card every block (what a naive pump would do)
    times, syncs = [], []
    for _ in range(blocks):
        t0 = time.perf_counter()
        engine.process_block()
        t1 = time.perf_counter()
        run.sync()
        t2 = time.perf_counter()
        times.append((t2 - t0) * 1e3)
        syncs.append((t2 - t1) * 1e3)
        if run.remaining() < run.reserve_s and len(times) >= 50:
            break
    synced_mean = float(np.mean(times))
    run.set(latency_p50_ms=float(np.median(times)),
            latency_mean_ms=synced_mean, sync_ms_p50=float(np.median(syncs)))

    # bounce drain: K blocks' masters in ONE device-to-host copy
    K, rounds = drain
    drained = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        masters = [engine.process_block().outputs.master for _ in range(K)]
        torch.cat(masters, dim=0).cpu()
        drained.append((time.perf_counter() - t0) / K * 1e3)
        if run.remaining() < run.reserve_s and len(drained) >= 3:
            break
    bounce_ms = float(np.median(drained))
    run.set(bounce_ms_per_block=bounce_ms,
            bounce_sync_amortization=synced_mean / max(bounce_ms, 1e-6))

    engine.drain_speculation()
    run.sync()
    calls = measure_kernel_resident(run, engine, *resident)
    roofline(run, calls)
    return {k: run.get(k) for k in CELLS}


def measure_kernel_resident(run: Run, engine, rounds: int = 5,
                            reps: int = 32) -> dict:
    """The live render alone: one real program (built by the host voice
    machine at the engine's current state; the pool is saved and restored
    around it), on the device once, re-enqueued. Sets `kernel_host_ms_p50`
    (host wall a render, `reps` renders and one sync a round, median of
    rounds), `kernel_ms_p50` (device ms a render: CUDA events around 3
    renders enqueued while the card spins for twice their enqueue time, so
    the pair holds no enqueue time; on the CPU the host wall again) and
    `dispatch_floor_ms` (the host wall loop over one trivial op). Returns
    the render's kernel calls (capture_calls)."""
    from . import convert
    from .device import on_device
    from .engine import hostcore
    from .ops import voice as voice_ops
    from .parallel import sharding

    clock = dict(block_start_sample=float(engine.clock.sample_position),
                 tick_anchor_sample=engine.clock.anchor_sample,
                 tick_anchor=engine.clock.anchor_tick,
                 samples_per_tick=engine.clock.samples_per_tick,
                 lane_enabled=engine.lane_enabled)
    snap = engine.pool.save_state()
    if engine.use_native_host:
        pi, pf, _ = hostcore.voice_update(engine.pool, **clock)
    else:
        pi, pf = voice_ops.pack_program(engine.pool.build_program(**clock))
    engine.pool.restore_state(snap)
    # over-envelope pitch: the engine's own fallback, the region-free gather
    fetch = engine.fetch if engine._fits_envelope(pi, pf) else "gather"
    fused = convert.upload(voice_ops.fuse_packed(pi, pf), engine.device)
    sound = engine._sound_data_for_backend()
    strips = engine._packed_strips_for_backend()

    def render():
        return sharding.render_block_sharded(
            engine.mesh, sound, fused, strips,
            block_frames=engine.block_frames, quirk_gain=engine.quirk_gain,
            fetch=fetch, max_pitch_ratio=engine.max_pitch_ratio)

    with on_device(engine.device):
        calls = capture_calls(render)
        run.sync()
        host_ms = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                render()
            run.sync()
            host_ms.append((time.perf_counter() - t0) / reps * 1e3)
            if run.remaining() < run.reserve_s:
                break
        run.set(kernel_host_ms_p50=float(np.median(host_ms)))

        if run.cuda:
            # 3 renders (~800 launches) fit the launch queue; the spin lasts
            # twice their enqueue at the host wall just measured (a cycle is
            # at least 0.5 ns: the card's clock stays under 2 GHz)
            spin_cycles = int(2 * 3 * float(np.median(host_ms)) * 2e6)
            device_ms = []
            for _ in range(max(rounds, 5)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(spin_cycles)
                start.record()
                for _ in range(3):
                    render()
                end.record()
                end.synchronize()
                device_ms.append(start.elapsed_time(end) / 3)
            run.set(kernel_ms_p50=float(np.median(device_ms)))
        else:
            run.set(kernel_ms_p50=float(np.median(host_ms)))

        x = torch.zeros(8, device=engine.device)
        floor_ms = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                x.add_(1.0)
            run.sync()
            floor_ms.append((time.perf_counter() - t0) / reps * 1e3)
        run.set(dispatch_floor_ms=float(np.median(floor_ms)))
    return calls


def kernel_calls(calls: dict) -> dict:
    """One render's five kernel calls (capture_calls' record of a render on
    one shard), each as a function of no arguments, with its bound
    (utils/roofline): {name: (call, bound)}, the names those of the line's
    `<name>_kernel_ms` keys."""
    from .ops import fetch_windows as fw
    from .ops import finish as fin
    from .ops import mixdown as md
    from .ops import voice_render as vr
    from .utils import roofline as rl

    counts = {name: len(c) for name, c in calls.items()}
    if set(counts.values()) != {1}:
        raise RuntimeError(f"the render made {counts} kernel calls, expected "
                           f"one of each")
    (args, r_max), = calls["fetch"]
    (contrib, lane, init), = calls["mixdown"]
    (prog, B, ratio), = calls["voice_prep"]
    post_args, = calls["voice_post"]
    fin_args, = calls["finish"]
    return {
        "voice_prep": (lambda: vr.voice_prep(prog, B, ratio),
                       rl.voice_prep_bound(prog, B)),
        "fetch": (lambda: fw.fetch_interp(*args, r_max=r_max),
                  rl.fetch_bound(args, r_max)),
        "voice_post": (lambda: vr.voice_post(*post_args),
                       rl.voice_post_bound(*post_args)),
        "mixdown": (lambda: md.lane_mixdown(contrib, lane, init=init),
                    rl.mixdown_bound(contrib, lane, init)),
        "finish": (lambda: fin.finish(*fin_args), rl.finish_bound(*fin_args)),
    }


def roofline(run: Run, calls: dict, iters: int = 50) -> None:
    """The five hand-written kernels on one render's inputs: their times
    (p50 of `iters` CUDA-event timings, L2 flushed, queued behind a spin;
    the host clock and the plain versions on the CPU) and the sum of their
    bounds. Sets `<name>_kernel_ms` for each (`fetch_kernel_ms`,
    `mixdown_kernel_ms`, `voice_prep_kernel_ms`, `voice_post_kernel_ms`,
    `finish_kernel_ms`), `kernel_bound_ms`, `kernel_pct_of_bound` (the bound
    over the kernels' time) and `pct_of_bound` (the bound over
    `device_ms_p50`)."""
    ms, bound_ms = {}, 0.0
    for name, (fn, bound) in kernel_calls(calls).items():
        for _ in range(3):
            fn()
        ms[name] = float(np.median(events_ms(fn, iters, True) if run.cuda
                                   else _host_ms(fn, iters)))
        bound_ms += bound["bound_ms"]
    run.set(**{f"{name}_kernel_ms": t for name, t in ms.items()},
            kernel_bound_ms=bound_ms,
            kernel_pct_of_bound=100.0 * bound_ms / sum(ms.values()))
    dev = run.get("device_ms_p50")
    if dev > 0:
        run.set(pct_of_bound=100.0 * bound_ms / dev)


def _best_chained(run: Run, engine, blocks: int, rounds: int = 4) -> float:
    """Best realtime factor of `rounds` rounds of blocks // rounds chained
    blocks, one sync a round, after 10 warm-up blocks."""
    _drive(engine, 10)
    run.sync()
    per_round = max(blocks // rounds, 1)
    rts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        _drive(engine, per_round)
        run.sync()
        rts.append(per_round * engine.block_frames / SAMPLE_RATE
                   / (time.perf_counter() - t0))
        if run.remaining() < run.reserve_s:
            break
    engine.drain_speculation()
    return max(rts)


def measure_reference_headline(run: Run, blocks: int = 400) -> float:
    """The reference engine's own headline polyphony: 96 voices (12
    channels x 8) in 1024-frame superblocks. Best round's realtime
    factor."""
    return _best_chained(run, run.session(SUPER_BLOCK, num_voices=96), blocks)


def measure_sparse_session(run: Run, blocks: int = 200) -> float:
    """The bucketed dispatch: 96 live voices on the full pool, 128-frame
    blocks; voice_buckets="auto" renders only the 128-voice prefix. Best
    round's realtime factor."""
    engine = run.session(LIVE_BLOCK, active_voices=96, voice_buckets="auto")
    return _best_chained(run, engine, blocks)


def measure_horizon_superblock(run: Run, blocks: int = 400) -> float:
    """The session's superblocks through the lookahead horizon at H=2
    (the reference's "auto" at B=1024), whatever the device's "auto"
    resolves to. Best round's realtime factor."""
    return _best_chained(run, run.session(SUPER_BLOCK, lookahead=2), blocks)


def measure_mesh_realtime(run: Run, shards: int, blocks: int = 40) -> float:
    """The per-block engine's superblock realtime factor on a mesh of
    `shards` shards of the run's one device (the voices split, every
    shard's kernels in one render graph a render, captured by warmup() and
    replayed a block; bit-equal to the unsharded engine)."""
    from .parallel.sharding import canonical_device, make_mesh

    first = canonical_device(run.device)
    engine = build_session(
        SUPER_BLOCK, run.num_voices, device=first, num_clips=run.num_clips,
        mesh=make_mesh(devices=[first] * shards), lookahead=0,
        fetch="windows")
    engine.warmup()
    _drive(engine, 5)
    run.sync()
    return chained_realtime(engine, blocks)["rt"]


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables (None unsets) for a block, then restore."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_session_wavs(tmp: str, num_clips: int = NUM_CLIPS) -> list:
    """session_plan's clips as WAV files under `tmp`; their paths."""
    from .io.wav import write_wav

    waves, _ = session_plan(SAMPLE_RATE, 0, num_clips)
    paths = []
    for i, w in enumerate(waves):
        paths.append(f"{tmp}/clip{i:02d}.wav")
        write_wav(paths[-1], w, SAMPLE_RATE)
    return paths


ABI_PLAY_CHANNEL = -2      # ClipAudioSource_play's channel (lane 0)


def abi_session(bridge, wavs: list, num_voices: int = NUM_VOICES) -> None:
    """The session through the C entry points: the clips by clip_new and
    clip_play (one looped voice each, on the ABI's play channel), the other
    voices as scheduled looped ClipCommands under the runtime lock (as an
    embedding host schedules notes), timer_start."""
    rt = bridge._rt()
    ids = [bridge.clip_new(p) for p in wavs]
    for cid in ids:
        bridge.clip_play(cid, True, ABI_PLAY_CHANNEL)
    _, voices = session_plan(SAMPLE_RATE, num_voices - len(ids), len(ids))
    for i, make_command in voices:
        cmd = make_command(ids[i])
        rt.run_locked(lambda cmd=cmd: rt.engine.schedule_clip_command(cmd, 0))
    bridge.timer_start(120)


def measure_pump(device, wavs: list, seconds: float = 5.0,
                 num_voices: int = NUM_VOICES, before=None,
                 after=None, render_graphs: str = "auto") -> dict:
    """The C ABI's wall-clock pump on `device` with a null sink and
    per-block delivery (bounce drain 1: what a pacing sink gets), the
    session loaded through the ABI while it runs, `seconds` of it measured:
    blocks rendered, wall seconds, block periods of that wall time and
    their ratio (`share`: 1.0 is realtime), with the engine's stats, the
    runtime's phase_stats and copy_wait span and the pump's error. `before(
    runtime)` runs once the pump is up, `after(engine)` once it has stopped
    and the speculation drained; its result is returned as "after".
    `render_graphs` is the engine's (LIBZL_TPU_RENDER_GRAPHS)."""
    from .capi import bridge

    with env_set(LIBZL_TPU_NO_PUMP=None, LIBZL_TPU_BACKEND=str(device),
                 LIBZL_TPU_VOICES=num_voices, LIBZL_TPU_BLOCK=LIVE_BLOCK,
                 LIBZL_TPU_BOUNCE_DRAIN=1, LIBZL_TPU_SINK="null",
                 LIBZL_TPU_RENDER_GRAPHS=render_graphs):
        bridge.init_engine()
    try:
        rt = bridge._rt()
        engine = rt.engine
        if rt._pump is None:
            raise RuntimeError("the pump did not start")
        if before is not None:
            before(rt)
        abi_session(bridge, wavs, num_voices)
        b0, t0 = engine.total_blocks, time.perf_counter()
        time.sleep(seconds)
        blocks = engine.total_blocks - b0
        wall = time.perf_counter() - t0
        rt.stop_pump()
        engine.drain_speculation()
        periods = wall * SAMPLE_RATE / LIVE_BLOCK
        return dict(
            blocks=blocks, wall=wall, periods=periods,
            share=blocks / periods, stats=engine.stats(),
            phase_stats=rt.phase_stats(),
            copy_wait=rt.profiler.summary().get("copy_wait", {}),
            error=rt.pump_error,
            after=None if after is None else after(engine))
    finally:
        bridge.shutdown_engine()


def measure_pump_share(run: Run, seconds: float = 5.0) -> float:
    """What a musician hears: the share of its block periods the ABI pump
    renders at the session's size (measure_pump). Raises on a pump error."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        r = measure_pump(run.device, write_session_wavs(tmp, run.num_clips),
                         seconds, run.num_voices)
    if r["error"] is not None:
        raise RuntimeError(f"pump error: {r['error']!r}")
    return r["share"]


def run_cells(run: Run, sizes: dict = FULL) -> None:
    """Every cell in the reference's order, each result into `run`. A cell
    that no longer fits the budget is skipped (`run.skipped`); one that
    raises is noted and listed in `run.failed`."""
    def cell(name: str, fn) -> None:
        if run.remaining() <= run.reserve_s:
            run.note(f"skipping {name} (budget)")
            run.skipped.append(name)
            return
        try:
            fn()
        except Exception as exc:  # noqa: BLE001: the line still prints
            run.note(f"{name} failed ({type(exc).__name__}: {exc})")
            run.failed.append(name)
        run.note(f"{name} done; remaining {run.remaining():.0f}s")

    def throughput():
        rt, active, rounds = measure_throughput(run, *sizes["throughput"])
        run.set(_rt_superblock=rt, _active=active, _rounds=rounds)

    run.set(device=device_line(run.device))
    cell("fence", lambda: run.set(fence_seconds=fence(run)))
    cell("throughput", throughput)
    cell("live", lambda: measure_live_mode(
        run, sizes["live_blocks"], sizes["drain"], sizes["resident"]))
    cell("96 voices", lambda: run.set(
        realtime_factor_96voices=measure_reference_headline(
            run, sizes["headline_blocks"])))
    cell("sparse", lambda: run.set(
        rt_liveblock_96on1024_bucketed=measure_sparse_session(
            run, sizes["sparse_blocks"])))
    cell("horizon", lambda: run.set(
        rt_superblock_lookahead2=measure_horizon_superblock(
            run, sizes["headline_blocks"])))
    for k in MESH_SHARDS:
        cell(f"mesh k={k}", lambda k=k: run.set(**{
            f"rt_superblock_mesh_k{k}": measure_mesh_realtime(
                run, k, sizes["mesh_blocks"])}))
    cell("pump", lambda: run.set(pump_realtime_share=measure_pump_share(
        run, sizes["pump_seconds"])))


def _watchdog(run: Run) -> None:
    """The hard budget: at the deadline print whatever completed and exit 0
    (os._exit: a stuck device call cannot be unwound from Python)."""
    delay = run.deadline - WATCHDOG_MARGIN_S - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    if run._printed.is_set():
        return
    run.note(f"budget ({run.budget_s:.0f}s) exhausted mid-cell; emitting a "
             "partial result")
    run.emit(partial=True)
    sys.stderr.flush()
    os._exit(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N or cpu (default cuda:0; no fallback)")
    ap.add_argument("--quick", action="store_true",
                    help="fewer rounds and blocks a cell")
    opts = ap.parse_args(argv)
    budget = float(os.environ.get("LIBZL_BENCH_BUDGET_S", "")
                   or DEFAULT_BUDGET_S)
    run = Run(opts.device, budget, reserve_s=min(20.0, budget / 10))
    if run.cuda and not torch.cuda.is_available():
        print(f"bench: device {opts.device!r} requested but "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    threading.Thread(target=_watchdog, args=(run,), daemon=True,
                     name="bench-budget-watchdog").start()
    run.note(f"self-budget {budget:.0f}s on {opts.device}")
    run_cells(run, QUICK if opts.quick else FULL)
    run.emit(partial=False)
    if run.failed:
        run.note(f"failed cells: {', '.join(run.failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
