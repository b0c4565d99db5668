#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (libzl_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--compare|--version NAME=PATH.cu[,NVCC_FLAG...]]
                          [--soak-seconds S] [--soak-event-seconds S]
    python3 chip_smoke.py --mesh-cards-only   # phases 1, 2, 13 across cards
    python3 chip_smoke.py --mesh-only         # phases 1, 2, 13
    python3 chip_smoke.py --mixdown-only      # phases 1, 2, the mixdown's 3, 5
    python3 chip_smoke.py --kernels-only      # phases 1, 2, 3
    python3 chip_smoke.py --graphs-only       # phases 1, 2, 16
    python3 chip_smoke.py --timing-only       # phases 1, 2, 5
    python3 chip_smoke.py --policy-only       # phases 1, 2, 17
    python3 chip_smoke.py --first-blocks-only # phases 1, 2, 18
    python3 chip_smoke.py ... --switch-ms MS  # the interpreter's switch
                                              # interval, from the start

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero:

1. environment — torch/CUDA/nvcc versions, the card's name and power limit;
   no CUDA device means exit 2 (this script never runs on the CPU);
2. build       — nvcc builds libzl_tpu_torch/csrc/*.cu for sm_90a, one
   process a source, all at once;
3. kernel      — the windows fetch kernel against its plain PyTorch version
   on the card, at (V, B) = (1024, 128) and (1024, 1024), f32 and int16
   banks, with engine-like and hostile positions (atol 2e-6 / 3e-6,
   out-of-range lanes exactly 0); each call prints how many voice chunks
   the kernel stages in shared memory and how many exceed that budget and
   read their taps directly, and the hostile calls must have both; the
   lane mixdown kernel against its plain version, torch.equal, at (V, B) =
   (1024, 128) and (1024, 1024), a stacked H=16 horizon at B=128, lanes
   outside [0, 12), a non-zero init and the shapes its tiling makes special
   (MIXDOWN_CASES), each through 16-, 8- and 4-byte copy chunks where the
   shape allows them; `out` written over `init`; a 4-byte aligned view;
   the voice prep, voice post and finish kernels against their plain
   versions, torch.equal: the prep on hostile programs (every ADSR stage
   and release mode, releases, starts and stops mid-block, wrap segments
   with loop periods, beat-quantized resets, inactive rows, pan at +-1) at
   (V, B) = (1024, 128) and (1024, 1024), (1000, 130) and (64, 10240) with
   67 resets, from strided and from own columns and as slices 1 and H-1 of
   hostile H=2 and H=16 horizons read from their compact dynamics (against
   unpack_horizon_slice + the plain prep), anchors included; the post on
   the fetch's taps of those programs, also into a stacked slice and an
   8-byte aligned view; the finish on one block's and a stacked H=16
   horizon's lane mix at B=128 and 1024, at B = 1, 31, 33, 255, 257, 4096
   (H=2), 16384, 16385, 16512 (H=1, 2) and 40000, each also with NaN, +inf
   and -inf frames (bit-equal, NaN in the same places), and a captured
   finish graph replayed twice at B=128 and 40000;
4. slice       — the north-star session (1024 voices, 64 looped clips at
   48 kHz, 120 BPM; the port of bench.py's build_session) through the
   per-block engine (lookahead=0, voice buckets off) on "cuda" (fetch
   resolves to the windows kernel) and on "cpu" (the plain
   gather path): 8 superblocks (B=1024), 16 live blocks (B=128), then 3
   blocks of 64 voices at B=10240 (67 beat-quantized reset columns), every
   block compared (voice_peaks atol 2e-6; lane_mix and master rtol
   1e-5, atol 2e-6 x voices in the densest lane); the voice prep, fetch
   and voice post kernels' launch counts must equal the dispatched blocks,
   the mixdown's and the finish's the engines' renders, and no block may
   fall back to gather;
5. timing      — per-block engine: superblock realtime factor, live-block
   ms, host program and dispatch ms (and the parts of a graph replay:
   slot wait, staging, output slot and tally, replay), a
   torch.profiler pass per geometry
   (device ms and kernels per block beside those of the render before its
   voice kernels, each kernel's share, device busy share, and the
   window's blocks by kind and its renders, so kernels a render); default
   engine, and beside it the horizon engine where the card's default is
   the per-block path (lookahead=2 at B=1024):
   realtime factor and ms/block at both geometries, SLO misses per kind,
   DSP load, the horizon-build / adoption-wait / emit spans, and a paced
   live run (one block per period); kernel and plain fetch ms on
   synthetic engine-like inputs and on the inputs of the session's last
   per-block dispatch, each beside its bound (the bytes its own inputs
   need at 3.35 TB/s, unique taps counted once) and the share of it
   reached (p50 over CUDA events: device time, and call time with the
   host's launch latency);
   the mixdown kernel (also through 8- and 4-byte copy chunks, with its
   inputs left in L2, and any --compare source of it), its plain version,
   the one-hot torch.matmul it replaces and an empty kernel on its grid, on
   the session's last per-block contributions at B=1024 and B=128 and on a
   stacked H=16 horizon at B=128, each beside its bound; the voice prep,
   voice post and finish kernels, their plain versions and any --compare
   source of them on the session's last per-block dispatch at B=1024 and
   B=128, the voice prep on slice 1 of a horizon over that program and the
   finish on a stacked H=16 horizon and at B=16512 and 40000, each beside
   its bound;
6. default engine — the session through the engine's default options on
   "cuda" (voice buckets; "auto" resolved as CARD_LOOKAHEAD
   says: the per-block path at B=1024 and B=256, H=16 at B=128), and a
   horizon engine at each of those B (lookahead=2 at B=1024, 8 at B=256,
   the default at B=128), through a horizon build, at least two
   adoptions of the chain, and two preemptions (a note-off, then a
   set_strip, mid-horizon) rebuilt in their event block; every block is
   compared with a "cpu" engine at lookahead=0 (the rule of phase 4) and
   the horizon engine with a "cuda" engine at lookahead=0 with the same
   buckets (the default where it is per-block): bit-equal; the options
   must resolve as CARD_LOOKAHEAD says; the fetch kernel's
   launches must equal the horizon
   slices and per-block blocks rendered with the windows fetch, the
   mixdown kernel's the horizons and per-block blocks dispatched, no
   gather fallback, no failed speculative build;
7. bridge       — the C ABI bridge (libzl_tpu_torch.capi.bridge) in process
   with LIBZL_TPU_NO_PUMP=1, 1024 voices, B=128: the 64 clips written as
   WAVs and loaded by clip_new, clip_play and timer_start, an in-memory
   non-pacing sink, 192 blocks with global-playback recording, then 192
   with a `lane:2` port recording added; on "cuda" with the bounce drain at
   its default (CARD_DRAIN, 64) and at 1, and on "cpu". The two "cuda" sink
   streams are
   bit-equal; both, and the lane recording, agree with "cpu" (phase 4's
   rule); the kernels' launches equal the engines' windows dispatches and
   renders;
8. pump         — the wall-clock pump on "cuda" for 5 s with a null sink and
   per-block delivery, the session loaded while it runs: no pump error, no
   failed speculative build; blocks rendered against block periods,
   phase_stats, SLO misses per kind and the per-block copy wait printed;
   every deadline miss printed with its kind, overrun and cause (a
   BlockTracer on the engine from before the pump starts, reading the
   program's span record; miss_cause: a recapture after the bank grew, a
   late capture, a collection, a graph's first realtime replay, the
   commands (the tick walk and its commands, the MIDI fabric),
   host_program, a dispatch part, horizon_build / adopt_wait / emit (each
   "stalled: GIL or scheduler" at 10x its median), or the time outside
   every span: a deferred clip render swapped in, the bank's upload, else
   GIL or scheduler), every miss named;
   the kernels' launches, counted from a drained engine held at the
   runtime lock, equal its windows dispatches and renders;
9. shim         — the port's libzl.so (native/libzl_shim.cpp built over the
   port's bridge) driven by libzl_tpu_torch.capi.abi_client in a subprocess
   on "cuda" at the ABI defaults: it must print CAPI-OK device=cuda (where
   Python.h is missing the phase prints NOT RUN and why);
10. thumbnails  — thumbnail_batch of the 64 clips on "cuda", min/max
   bit-equal to the CPU, timed;
11. CLI         — `python -m libzl_tpu_torch.cli render ... --device cuda`
   for 2 s of a looped clip: the WAV's peak must exceed 0.05;
12. stretch     — the torch.fft vocoder (ops/stretch_torch) on "cuda": a 2 s
   stereo clip at factors 0.5, 1.37 and 2.0 against the same call on "cpu"
   (max abs error <= 1e-3 x the peak), each card run twice with the same
   bits; a clip speed change through a "cuda" engine with
   LIBZL_TPU_STRETCH=torch, waiting for the deferred re-render; ms of the
   card vocoder beside the native WSOLA and the numpy vocoder on that clip;
13. mesh        — the north-star session through AudioEngine("cuda:0",
   mesh=make_mesh(devices=["cuda:0"] * k)) for k = 2 and 4, each with
   render graphs (the default: one graph a render) and with render_graphs
   "off", at B=1024 and B=128, per-block (lookahead=0) and through the
   horizon (lookahead=2 at B=1024, the default at B=128),
   every block against the unsharded "cuda" engine of the same
   options: master, lane_mix, lane_peaks, lane_rms and voice_peaks
   bit-equal (the carried in-order lane mixdown); the windows kernel's
   launches must equal the unsharded engine's windows blocks plus k x each
   mesh engine's (the voice prep and post alike), the mixdown kernel's k x
   each engine's renders, the finish's each engine's renders, every
   render of a graph engine a replay, a late capture or a stale render;
   each shard's fetch and mixdown call (V/k voices) bit-equal to the plain
   version; realtime factor, process_block ms, device ms and kernels a
   block, warmup and capture seconds and graph memory per k and path;
   across every card where there are two or more (per-block at B=1024 and
   default at B=128, a chain of per-card graphs and eager, the same checks,
   each card's calls held to the plain versions on that card);
14. soak        — the C ABI bridge on "cuda" with its wall-clock pump, 1024
   voices, B=128, a file sink: four sine WAVs by clip_new, played looped,
   global playback recorded to a file, a random clip retriggered every
   --soak-event-seconds for --soak-seconds (tools/tpu_soak_r3.py's run);
   its counters on one line; fails on a pump error, a failed speculative
   build, a watchdog mismatch or lost event, a non-finite, silent or short
   recording (under 0.95 x the recorded blocks); deadline misses and
   sustained realtime are printed, not held; the kernels' launches equal
   the engine's dispatches; then live_rig and midi_live_demo
   (libzl_tpu_torch/examples) on "cuda" for 1 s each: "live rig OK", a
   WAV peak above 0.005;
15. bench       — the port's benchmark (python -m libzl_tpu_torch.bench) in
   process at its short sizes: every key of its line present, every cell
   finite and positive, none failed or skipped, no share of a bound over
   100, every kernel launched; the line printed behind the card's name;
16. graphs      — render graphs (libzl_tpu_torch/engine/graphs.py): every
   captured graph of a default engine and of the horizon engine beside it
   where the default is per-block (lookahead=2 at B=1024; f32 and int16
   banks) replayed on
   the session's real programs, every output field
   bit-equal to the eager render_block_sharded / render_horizon_sharded of
   the same program and to the graph's replay() + clone() (the native
   replay: every replay of a one-card engine through it, its output slots
   and fallbacks printed); a 384-block default session at B=128 with graphs
   ("auto") and without ("off") in lockstep, bit-equal every block across a
   clip load, a strips change and a note-off; then, for each path in
   turns (auto, off, off, auto), the superblock realtime factor and
   process_block p50, the live p50 and chained mean, the default engine's
   p50, mean, horizon build and adoption spans at B=128, its paced lag,
   its realtime factor at B=1024, the pump's share of its periods, and
   warmup's seconds, capture seconds, graph count, graph memory and
   memory_reserved growth;
17. policy      — only with --policy-only: the dispatch defaults swept on
   the session, 3 interleaved rounds a setting in rotated order, medians
   and spreads: lookahead H in 0, 2, 4, 8, 16 at B = 128, 256 and 1024
   (realtime factor, process_block p50 / p99 / mean, deadline misses by
   kind with the first block after warmup apart, paced lag at B <= 256,
   the horizon spans, renders and kernels a block); the ABI pump at B=128
   at H = 0, 8, 16 (share of its periods, copy wait, misses); the bounce
   drain's K in 1, 8, 16, 32, 64 through the bridge with a null sink at
   B=1024 and 128 (ms a block, the flush phases). Each prints the decision
   PERF.md's rule takes from its numbers beside what "auto" resolves to in
   the code.
   Every lookahead setting prints its graphs warm-replayed and its warm
   replays, and each deadline miss with its cause (phase 8's naming), the
   first block after warmup's apart; the pump's by cause;
18. first blocks — the first 8 blocks after warmup: the session's
   default engines at B=128 (H=16) and B=1024 (H=0), the per-block engine
   at B=128 and a lookahead=2 engine at B=1024; for each, an engine never
   warmed, then 2 engines (6 under --first-blocks-only) built fresh,
   warmed and synchronized, 8 chained blocks each under a BlockTracer.
   Held: every captured graph warm-replayed, no late capture or
   recapture, the caching allocator's segment.all.allocated unchanged
   over the 8 blocks, no generation-2 collection in them, every output
   field of every block bit-equal to the never-warmed engine's. Printed:
   the first block's ms beside blocks 2-8's p50, its spans, the
   collections, segments and alloc retries, and each miss with its cause.
   Then the default engines' first 8 blocks after a clip load that
   outgrows the bank (block 1 captures every graph again): held, every
   graph captured again and warm-replayed, no late capture, the launches
   equal to the dispatches with the warm launches apart, the bits equal
   to a never-warmed engine's; printed, block 1's ms and capture time,
   and the first realtime replays in blocks 2-8;

Every phase prints its wall seconds. The line before the last holds the
kernels' record as JSON, one entry a kernel (its launches are those of
phases 4, 6, 7, 8, 13, 14, 15 and 16, each counted from 0 around its run; `ms`,
`plain_ms`, `bound_ms` and `library_ms` are those of the inputs named by its
`inputs`: for the fetch fixed synthetic inputs, with its `session_` keys
those of the session's last per-block dispatch at B=1024; for the mixdown
that dispatch's contributions; for the voice prep, voice post and finish
that dispatch's own calls); the last line is {"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

try:
    from libzl_tpu_torch import bench
    from libzl_tpu_torch.ops import launch_tally
    from libzl_tpu_torch.utils.roofline import fetch_bound, mixdown_bound
except ImportError as exc:
    print(f"chip_smoke: the port's package is not beside this script "
          f"({exc})", file=sys.stderr)
    sys.exit(2)

# the session (also through the C ABI), the event timer, the kernel-call
# capture, the chained realtime factor and the pump run are the benchmark's
# (libzl_tpu_torch/bench.py)
session_plan = bench.session_plan
build_session = bench.populate_session
_events_ms = bench.events_ms
time_mesh = bench.chained_realtime
_env = bench.env_set
abi_session = bench.abi_session

NUM_VOICES = 1024
NUM_CLIPS = 64
SAMPLE_RATE = 48000
SUPER_BLOCK = 1024
LIVE_BLOCK = 128
SLICE_SUPER_BLOCKS = 8
SLICE_LIVE_BLOCKS = 16
# phase 4's large block: B=10240 takes W = 67 beat-quantized resets a voice
# at 48 kHz (constants.bq_extra_resets), past the 64 of the first voice prep
LARGE_BLOCK = 10240
LARGE_VOICES = 64
LARGE_BLOCKS = 3
# phases 4 and 5 drive the per-block engine (their figures stay comparable
# with the per-block records in PERF.md); phase 6 the default options
PER_BLOCK = dict(lookahead=0, voice_buckets="off")
BANK_FRAMES = 1 << 22      # SoundBank's default capacity

FETCH_ATOL = 2e-6          # tests/test_fetch_windows.py:54
HOSTILE_ATOL = 3e-6        # tests/test_fetch_windows.py:294
PEAK_ATOL = 2e-6
MIX_RTOL = 1e-5
MIX_ATOL_PER_VOICE = 2e-6

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "libzl_tpu_torch/csrc/fetch_interp.cu"
KERNEL_REPLACES = "libzl_tpu/ops/fetch_pallas.py:450"
# the kernel record's timed inputs (phase 5's draws from seed 99)
SYNTHETIC_INPUTS = (f"kernel_inputs engine-like, V={NUM_VOICES} "
                    f"B={SUPER_BLOCK}, f32 bank, seed 99")
MIXDOWN_SOURCE = "libzl_tpu_torch/csrc/lane_mixdown.cu"
# an XLA dot_general of a one-hot [12, V] by [V, 2B], not a Pallas kernel
MIXDOWN_REPLACES = "libzl_tpu/ops/voice.py:687"
MIXDOWN_INPUTS = (f"the north-star session's last per-block contributions, "
                  f"V={NUM_VOICES} B={SUPER_BLOCK}")
# the kernels around the fetch and the mixdown: (source, what each replaces,
# XLA-fused in the reference, not Pallas)
RENDER_KERNELS = {
    "voice_prep": ("libzl_tpu_torch/csrc/voice_prep.cu",
                   "libzl_tpu/ops/voice.py:496"),
    "voice_post": ("libzl_tpu_torch/csrc/voice_post.cu",
                   "libzl_tpu/ops/voice.py:612"),
    "finish_block": ("libzl_tpu_torch/csrc/finish_block.cu",
                     "libzl_tpu/engine/render.py:50"),
}
RENDER_INPUTS = (f"the north-star session's last per-block dispatch, "
                 f"V={NUM_VOICES} B={SUPER_BLOCK}")
# the per-block engine with graphs before the voice kernels, when a block's
# body was ~260 plain ops (PERF.md section 5): device ms and kernels a block
PLAIN_BODY_DEVICE = {SUPER_BLOCK: (0.776, 275), LIVE_BLOCK: (0.465, 260)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    launch_tally.reset()


def read_launches() -> dict:
    """Every kernel's launch count, by name: fetch_interp, lane_mixdown,
    voice_prep, voice_post, finish_block."""
    return launch_tally.counts()


def add_launches(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def renders(engines) -> int:
    """The lane mixdowns the engines' renders launch: one a shard for each
    per-block and each horizon dispatch."""
    return sum(e.mesh.size * sum(e.render_dispatches.values())
               for e in engines)


def reset_counts(engines) -> None:
    """Zero the engines' dispatch counts and their render graphs' replay
    counts and warm launches."""
    for e in engines:
        e.fetch_dispatches = {"windows": 0, "gather": 0}
        e.render_dispatches = {"block": 0, "horizon": 0}
        e.late_captures = 0
        if e._graphs is not None:
            e._graphs.replays = e._graphs.stale = 0
            getattr(e._graphs, "warm_launches", {}).clear()


def dispatched_launches(launches: dict, engines) -> dict:
    """`launches` less the engines' graphs' warm launches (warm replays,
    a recapture's warm-up renders: launches no dispatch made)."""
    out = dict(launches)
    for e in engines:
        if e._graphs is not None:
            for name, n in getattr(e._graphs, "warm_launches", {}).items():
                out[name] -= n
    return out


def check_launches(launches: dict, windows: int, engines, label: str):
    """The voice prep, fetch and voice post kernels launched once a windows
    block (x shards: `windows` counts them), the mixdown once a shard a
    render, the finish once a render; every render of a graph engine a
    graph replay or a capture (check_graph_renders). The graphs' warm
    launches are counted apart (dispatched_launches)."""
    launches = dispatched_launches(launches, engines)
    for name in ("voice_prep", "fetch_interp", "voice_post"):
        check(launches[name] == windows,
              f"{label}: {name} kernel launched {launches[name]} times for "
              f"{windows} windows blocks")
    want = renders(engines)
    check(launches["lane_mixdown"] == want,
          f"{label}: mixdown kernel launched {launches['lane_mixdown']} "
          f"times for {want} shard renders")
    want = sum(sum(e.render_dispatches.values()) for e in engines)
    check(launches["finish_block"] == want,
          f"{label}: finish kernel launched {launches['finish_block']} times "
          f"for {want} renders")
    for e in engines:
        check_graph_renders(e, label)


def check_graph_renders(engine, label: str) -> None:
    """An engine with render graphs, on one shard or a mesh of k, replayed
    its captured graphs for every render since its counts were zeroed, or
    captured them then (late captures; stale renders: the bank grew under
    a queued render). render_graphs "off" renders eagerly."""
    stats = engine.stats()
    if engine.render_graphs == "off":
        check(stats["render_graphs"] == "eager",
              f"{label}: {stats['render_graphs']} renders")
        return
    n = sum(engine.render_dispatches.values())
    got = (stats["graph_replays"] + stats["late_captures"]
           + stats["graph_stale_renders"])
    check(stats["render_graphs"] == "graphs" and n == got,
          f"{label}: {n} renders, {stats['graph_replays']} graph replays + "
          f"{stats['late_captures']} late captures + "
          f"{stats['graph_stale_renders']} stale")


@contextlib.contextmanager
def eager_renders(engine):
    """The engine's renders dispatched eagerly inside the block, as with
    render_graphs "off": a replayed graph makes no kernel call from Python
    for bench.capture_calls to see."""
    graphs, engine._graphs = engine._graphs, None
    try:
        yield
    finally:
        engine._graphs = graphs


def note_off(engine, voice: int) -> None:
    """Schedule a stop of `voice`'s note (its clip, channel and note: the
    reference's stop-matching identity)."""
    from libzl_tpu_torch.engine.commands import ClipCommand

    pool = engine.pool
    cmd = ClipCommand.channel(int(pool.clip_id[voice]),
                              int(pool.midi_channel[voice]))
    cmd.midi_note = int(pool.midi_note[voice])
    cmd.stop_playback = True
    engine.schedule_clip_command(cmd, 0)


# ------------------------------------------------------------------ phases


def phase_environment() -> str:
    from libzl_tpu_torch import _build

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-2] if len(nvcc) > 1 else nvcc[-1]}")
    card = bench.device_line("cuda:0")
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    torch.cuda.synchronize()
    return card


def phase_build() -> None:
    from libzl_tpu_torch import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds:.2f} s) -> {so.name}")
    # ptxas -v: each kernel's name, then its stack and spills, then its
    # registers
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("Function properties", "registers",
                                   "spill")):
            print(f"  ptxas: {line.strip()}")
    torch.cuda.synchronize()


def kernel_inputs(rng, V: int, B: int, n: int, dtype, hostile: bool,
                  device):
    """Random bank, windows and window-relative positions for regions of
    region_rows(B, R_MAX). Engine-like draws keep each voice's positions
    inside its regions at one whole-sample pitch ratio up to R_MAX, each
    frame in region A or B at random; hostile draws add negative,
    past-the-end and region-edge positions (p = region-1 reads region B's
    first sample at tap p+1; 2*region-2 is the last valid position,
    2*region-1 the first invalid one)."""
    from libzl_tpu_torch.ops.fetch_windows import R_MAX as r_max
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    region = region_rows(B, r_max)
    sound = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    if dtype == torch.int16:
        sound = np.clip(np.round(sound * np.float32(32767.0)),
                        -32768, 32767).astype(np.int16)
    max_blk = (n - region) // 512
    win_a = rng.integers(0, max_blk, V).astype(np.int32)
    win_b = rng.integers(0, max_blk, V).astype(np.int32)
    span = int(r_max * B) + 2
    base_a = rng.integers(0, region - span, V)[:, None]
    base_b = region + rng.integers(0, region - span, V)[:, None]
    # whole-sample ratios 0..r_max per voice
    step = rng.integers(0, int(r_max) + 1, (V, 1))
    frames = np.arange(B)[None, :]
    seg = rng.integers(0, 2, (V, B))
    pos = np.where(seg == 0, base_a + frames * step, base_b + frames * step)
    if hostile:
        # even voices play as the engine does, region A's run to its last
        # sample (tap p+1 == region reads region B's first sample) up to a
        # wrap frame, then region B from its start; odd voices get the
        # hostile positions
        wrap = rng.integers(0, B + 1, (V, 1))
        even = (np.arange(V) % 2 == 0)[:, None]
        end_a = region - 1 - np.maximum(wrap - 1, 0) * step
        pos = np.where(even & (frames < wrap), end_a + frames * step, pos)
        pos = np.where(even & (frames >= wrap),
                       region + (frames - wrap) * step, pos)
        kind = np.where(even, 0, rng.integers(0, 6, (V, B)))
        pos = np.where(kind == 2, rng.integers(-100, 0, (V, B)), pos)
        pos = np.where(kind == 3, rng.integers(2 * region - 1,
                                               2 * region + 100, (V, B)), pos)
        edges = np.array([region - 1, region, 2 * region - 2, 2 * region - 1,
                          0, -1])
        pos = np.where(kind == 4, edges[rng.integers(0, 6, (V, B))], pos)
    pos = pos.astype(np.int32)
    alpha = rng.random((V, B)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (sound, pos, alpha, win_a, win_b))


def stage_split(args, r_max: float = 4.0) -> tuple:
    """(staged, direct, cap): how many (voice, frame chunk) items of one
    kernel call stage their taps in shared memory and how many exceed the
    budget of `cap` samples a channel and read their taps directly, by the
    kernel's own plan (csrc/fetch_interp.cu: 1024-frame chunks at most, each
    region's tap range aligned to 16 bytes)."""
    from libzl_tpu_torch import _build
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    sound, pos, _, win_a, win_b = (t.cpu().numpy() for t in args)
    V, B = pos.shape
    region = region_rows(B, r_max)
    vec = 16 // sound.itemsize
    cap = _build.load().zl_fetch_interp_stage_cap(
        B, region, int(sound.dtype == np.int16))
    chunk = min(-(-B // 128) * 128, 1024)
    p = np.pad(pos.astype(np.int64), ((0, 0), (0, -B % chunk)),
               constant_values=-1).reshape(V, -1, chunk)
    ok = (p >= 0) & (p < 2 * region - 1)
    in_a, in_b = ok & (p < region), ok & (p >= region)
    cross = in_a & (p + 1 == region)  # tap p+1 is region B's first sample
    top, bottom = np.iinfo(np.int64).max, np.iinfo(np.int64).min

    def run(lo, hi, base):  # staged samples of one region's tap range
        has = lo <= hi
        lo, hi = np.where(has, lo, 0), np.where(has, hi, 0)
        start = (base + lo) & -vec
        return np.where(has, (base + hi - start + vec) // vec * vec, 0)

    na = run(np.where(in_a, p, top).min(-1),
             np.where(in_a, np.minimum(p + 1, region - 1), bottom).max(-1),
             win_a.astype(np.int64)[:, None] * 512)
    nb = run(np.minimum(np.where(in_b, p, top).min(-1),
                        np.where(cross, region, top).min(-1)),
             np.maximum(np.where(in_b, p + 1, bottom).max(-1),
                        np.where(cross, region, bottom).max(-1)),
             win_b.astype(np.int64)[:, None] * 512 - region)
    over = na + nb > cap
    return int((~over).sum()), int(over.sum()), cap


def phase_kernel(device) -> float:
    from libzl_tpu_torch.ops import fetch_windows as fw

    rng = np.random.default_rng(1234)
    worst = 0.0
    for V, B in ((NUM_VOICES, LIVE_BLOCK), (NUM_VOICES, SUPER_BLOCK)):
        region = fw.region_rows(B)
        for dtype in (torch.float32, torch.int16):
            for hostile in (False, True):
                args = kernel_inputs(rng, V, B, BANK_FRAMES, dtype, hostile,
                                     device)
                got = fw.fetch_interp(*args)
                want = fw.fetch_interp_plain(*args)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                pos = args[1]
                out_of_range = (pos < 0) | (pos >= 2 * region - 1)
                oor = got.permute(1, 0, 2)[:, out_of_range]
                oor_max = float(oor.abs().max()) if oor.numel() else 0.0
                tol = HOSTILE_ATOL if hostile else FETCH_ATOL
                staged, direct, cap = stage_split(args)
                print(f"kernel V={V} B={B} {str(dtype)[6:]} "
                      f"{'hostile' if hostile else 'engine '}: max_abs_err "
                      f"{err:.3e} (atol {tol:g}), out-of-range lanes "
                      f"{int(out_of_range.sum())} max |out| {oor_max}; "
                      f"voice chunks staged {staged}, over the "
                      f"{cap}-sample budget (direct taps) {direct}")
                check(bool(torch.isfinite(got).all()), "non-finite output")
                check(err <= tol, f"kernel disagrees with plain: {err}")
                check(oor_max == 0.0, "out-of-range lane is not exactly 0")
                # both of the kernel's tap paths ran and were compared
                check(staged > 0 and (direct > 0 or not hostile),
                      f"staged {staged} / direct {direct} voice chunks")
                worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


# The kernel keeps 128 rows of a lane in flight, adds and refills them 16 at
# a time and lists 1024 voices at a time: lane i of a "ring" draw holds
# RING_COUNTS[i] voices, one below, at and above half that depth, the depth
# and twice it.
RING_COUNTS = (63, 64, 65, 127, 128, 129, 255, 256, 257)
RING_VOICES = sum(RING_COUNTS) + 40          # and 40 voices of no lane

# (V, B, H, lanes, non-zero init); H=0 is one block; lanes "session" (v % 10,
# as the session's), "stray" (random with some outside [0, 12)), "one" (every
# voice in lane 3) or "ring". The main path's shapes, then the shapes the
# kernel's tiling makes special (tests/test_torch_kernels.py TILING_CASES):
# E = 2B not a multiple of the 128-element tile or of 4, lanes around the
# ring's depth, one lane many rings deep, V not a multiple of 32 and past
# one listing, E = 2.
MIXDOWN_CASES = ((NUM_VOICES, LIVE_BLOCK, 0, "session", False),
                 (NUM_VOICES, SUPER_BLOCK, 0, "session", False),
                 (NUM_VOICES, LIVE_BLOCK, 16, "session", False),
                 (NUM_VOICES, LIVE_BLOCK, 0, "stray", False),
                 (NUM_VOICES, SUPER_BLOCK, 0, "stray", True),
                 (NUM_VOICES, LIVE_BLOCK, 16, "stray", True),
                 (RING_VOICES, 6, 0, "ring", False),
                 (RING_VOICES, 65, 0, "ring", True),
                 (RING_VOICES, LIVE_BLOCK, 2, "ring", True),
                 (NUM_VOICES, 16, 0, "one", False),
                 (2500, 33, 0, "one", True),
                 (1000, 100, 0, "stray", False),
                 (1025, 64, 2, "stray", False),
                 (300, 1, 0, "stray", True),
                 (77, 130, 3, "stray", True))


def mixdown_inputs(rng, V: int, B: int, H: int, lanes: str, init: bool,
                   device) -> tuple:
    """(contrib [V, B, 2] or [H, V, B, 2], lane int32 [V], init or None)
    on `device`: contributions at the session's scale with exact zeros and
    lanes drawn as `lanes` says (MIXDOWN_CASES)."""
    lead = (H,) if H else ()
    contrib = (0.3 * rng.standard_normal(lead + (V, B, 2))).astype(np.float32)
    contrib[rng.random(contrib.shape) < 0.1] = 0.0
    if lanes == "session":
        lane = np.arange(V) % 10
    elif lanes == "one":
        lane = np.full(V, 3)
    elif lanes == "ring":
        lane = rng.permutation(np.concatenate(
            [np.full(n, i) for i, n in enumerate(RING_COUNTS)]
            + [np.full(V - sum(RING_COUNTS), -1)]))
    else:
        lane = np.where(rng.random(V) < 0.15,
                        rng.choice([-7, -1, 12, 100], V),
                        rng.integers(0, 12, V))
    start = (rng.standard_normal(lead + (12, B, 2)).astype(np.float32)
             if init else None)
    return (torch.from_numpy(contrib).to(device),
            torch.from_numpy(lane.astype(np.int32)).to(device),
            None if start is None else torch.from_numpy(start).to(device))


def phase_mixdown(device) -> float:
    """The lane mixdown kernel against its plain version on the card,
    torch.equal at each of MIXDOWN_CASES: through the copy chunk the kernel
    takes (the widest the shape allows: 4, 2 or 1 floats) and through each
    narrower one; then `out` written over `init`, and contributions 4 bytes
    into their storage (one-float chunks). Returns the max abs error (0)."""
    from libzl_tpu_torch import _build
    from libzl_tpu_torch.ops import mixdown as md

    lib = _build.load()
    rng = np.random.default_rng(4321)
    worst = 0.0
    for V, B, H, lanes, init in MIXDOWN_CASES:
        contrib, lane, start = mixdown_inputs(rng, V, B, H, lanes, init,
                                              device)
        want = md.lane_mixdown_plain(contrib, lane, init=start)
        widths = [0] + [vec for vec in (4, 2, 1) if 2 * B % vec == 0]
        for vec in widths:
            got = (md.lane_mixdown(contrib, lane, init=start) if vec == 0
                   else md.launch_kernel(contrib, lane, init=start, vec=vec))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()), "non-finite mixdown")
            check(torch.equal(got, want), f"mixdown kernel (chunk {vec}) "
                  f"differs from plain at V={V} B={B} H={H}: {err:.3e}")
            worst = max(worst, err)
        print(f"mixdown V={V} B={B}" + (f" H={H}" if H else "")
              + f", lanes {lanes}" + (", non-zero init" if init else "")
              + f": max_abs_err {worst:.3e}, torch.equal True through the "
              f"widest copy chunk and through chunks of {widths[1:]} floats")

    # `out` aliasing `init`, through the C entry point
    contrib, lane, start = mixdown_inputs(rng, NUM_VOICES, LIVE_BLOCK, 2,
                                          "session", True, device)
    want = md.lane_mixdown(contrib, lane, init=start)
    code = lib.zl_lane_mixdown(
        contrib.data_ptr(), lane.data_ptr(), 0, start.data_ptr(),
        start.data_ptr(), 2, NUM_VOICES, 2 * LIVE_BLOCK, 12,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "lane_mixdown over its init")
    torch.cuda.synchronize()
    check(torch.equal(start, want), "mixdown written over its init differs")

    # a 4-byte aligned view copies in one-float chunks; wider are refused
    contrib, lane, _ = mixdown_inputs(rng, NUM_VOICES, LIVE_BLOCK, 0,
                                      "session", False, device)
    flat = torch.zeros(contrib.numel() + 1, device=device)
    flat[1:] = contrib.reshape(-1)
    view = flat[1:].view(contrib.shape)
    want = md.lane_mixdown_plain(view, lane)
    check(torch.equal(md.lane_mixdown(view, lane), want),
          "mixdown of a 4-byte aligned view differs from plain")
    try:
        md.launch_kernel(view, lane, vec=2)
    except RuntimeError:
        pass
    else:
        raise SmokeFailure("a 4-byte aligned view took two-float chunks")
    torch.cuda.synchronize()
    print("mixdown: out over init bit-equal to a separate output; a 4-byte "
          "aligned view bit-equal through one-float chunks")
    return worst


def render_program(rng, V: int, B: int, W: int, device):
    """A hostile V-voice program on `device`, as a block's render sees it
    (strided column views of the fused program): every ADSR stage and both
    release modes, releases at and before frame 0, mid-block and past the
    block, immediate cuts and sub-frame releases, starts and stops
    mid-block, up to S-1 wrap segments with and without a loop period, W
    beat-quantized resets, negative positions, inactive rows, pan at -1, +1
    and between (tests/test_torch_kernels.hostile_program's kinds)."""
    from libzl_tpu_torch.ops import adsr, voice

    S = voice.MAX_SEGMENTS_PER_BLOCK
    i32, f32 = np.int32, np.float32
    start = np.where(rng.random(V) < 0.3, rng.integers(1, B, V), 0)
    seg_start = np.full((V, S), B)
    seg_start[:, 0] = start
    for v in range(V):
        n = int(rng.integers(0, S))
        seg_start[v, 1:1 + n] = np.sort(rng.integers(start[v] + 1, B + 1, n))
    inv_rel = rng.choice([0.0, 2e-4, 1e-3, 2e-3, 0.5, 1.5], V)
    rel_log2 = np.where(inv_rel >= 1, -200.0, np.log2(
        f32(1) - np.minimum(inv_rel, 0.5).astype(f32)))
    release = rng.choice([0, 1, B // 2, B - 1, B + 5, int(voice.RELEASE_NONE),
                          -1], V)
    release = np.where(rng.random(V) < 0.4, rng.integers(0, B, V), release)
    env = adsr.AdsrProgram(
        stage0=rng.integers(0, 5, V), env0=rng.uniform(0, 1, V),
        a_rate=np.where(rng.random(V) < 0.2, 0.0, rng.uniform(0, 0.02, V)),
        d_rate=np.where(rng.random(V) < 0.2, 0.0, rng.uniform(0, 0.002, V)),
        sustain=rng.uniform(0, 1, V), rel_rate=rng.uniform(0, 0.002, V),
        inv_rel=inv_rel, rel_log2=rel_log2, release_frame=release,
        rel_mode=rng.integers(0, 2, V))
    pan = rng.uniform(-1, 1, V)
    pan[rng.random(V) < 0.3] = rng.choice([-1.0, 1.0])
    prog = voice.VoiceProgram(
        active=(rng.random(V) < 0.85).astype(i32),
        base=rng.integers(0, 4096, V), len_minus1=rng.integers(1, 40000, V),
        win_blk_a=rng.integers(0, 64, V), win_blk_b=rng.integers(0, 64, V),
        seg_start=seg_start, seg_pos_int=rng.integers(-40, 30000, (V, S)),
        seg_pos_frac=rng.random((V, S)), rate_int=rng.integers(0, 4, V),
        rate_frac=rng.random(V), start_frame=start,
        stop_frame=np.where(rng.random(V) < 0.3, rng.integers(1, B + 1, V),
                            B),
        gain=rng.uniform(0, 1, V), clip_volume=rng.uniform(0, 1, V), pan=pan,
        lane=rng.integers(0, 12, V),
        loop_period=np.where(rng.random(V) < 0.5, rng.integers(20, 400, V),
                             0),
        bq_reset=np.minimum(np.sort(rng.integers(0, B + B // 2, (V, W)),
                                    axis=1), B),
        env=env)
    fused = voice.fuse_packed(*voice.pack_program(prog))
    return voice.unpack_program(*voice.split_fused(
        torch.from_numpy(fused).to(device)))


def own_columns(prog):
    """The program with every column a tensor of its own, as a horizon
    slice's are (ops/voice.unpack_horizon_slice)."""
    return prog._replace(
        env=prog.env._replace(**{n: getattr(prog.env, n).contiguous()
                                 for n in prog.env._fields}),
        **{n: getattr(prog, n).contiguous() for n in prog._fields
           if n != "env"})


def render_dynamics(rng, V: int, B: int, H: int, W: int, device):
    """Compact horizon dynamics [V, 1+(H-1)*D] int32 on `device`, in
    ops/voice.pack_horizon_dynamics' layout, that reach every branch of a
    slice's unpack (tests/test_torch_kernels.hostile_dynamics' kinds):
    negative positions, wraps in and past the block, stops mid-block,
    releases at 0, mid-block and none (0xFFFF), every stage and release
    mode, inactive rows, W 16-bit resets in and past the block."""
    from libzl_tpu_torch.ops import voice

    def pack16(lo, hi):
        return ((np.asarray(hi, np.uint32) << 16)
                | np.asarray(lo, np.uint32)).view(np.int32)

    S = voice.MAX_SEGMENTS_PER_BLOCK
    npack, D = (S + 1) // 2, voice.horizon_dyn_cols(W)
    dyn = np.zeros((V, 1 + (H - 1) * D), np.int32)
    bits = dyn.view(np.float32)
    dyn[:, 0] = rng.integers(0, 30000, V)
    for t in range(H - 1):
        off = 1 + t * D
        dyn[:, off] = rng.integers(-3000, 30000, V)
        bits[:, off + 1:off + 4] = rng.random((V, 3)) * [1.0, 1.0, 0.002]
        fields = np.concatenate([
            np.sort(rng.integers(1, B + B // 4 + 2, (V, S - 1)), axis=1),
            np.where(rng.random((V, 1)) < 0.3,
                     rng.integers(1, B + 1, (V, 1)), B),
            np.zeros((V, S % 2), np.int64)], axis=1)
        dyn[:, off + 4:off + 4 + npack] = pack16(fields[:, 0::2],
                                                 fields[:, 1::2])
        rf = np.where(rng.random(V) < 0.4, rng.integers(0, B, V),
                      rng.choice([0, 1, B // 2, B - 1, 0xFFFF], V))
        dyn[:, off + 4 + npack] = (
            rf | (rng.random(V) < 0.85) << 16
            | rng.integers(0, 5, V) << 17 | rng.integers(0, 2, V) << 20)
        resets = np.concatenate([
            np.minimum(np.sort(rng.integers(0, B + B // 2, (V, W)), axis=1),
                       0xFFFF), np.zeros((V, W % 2), np.int64)], axis=1)
        dyn[:, off + 5 + npack:off + D] = pack16(resets[:, 0::2],
                                                 resets[:, 1::2])
    return torch.from_numpy(dyn).to(device)


def finish_inputs(rng, H: int, B: int, device, specials: bool = False):
    """A lane mix [H, 12, B, 2] with exact zeros and -0.0 mixed in, and
    packed strips [5, 11] with muted strips and pans at -1 and +1;
    `specials`: in the last slice a NaN frame in lane 3, +inf in lane 5,
    -inf in lane 8, and +inf in lane 10 beside -inf in lane 11 on one frame
    (the master's inf - inf)."""
    mix = (rng.standard_normal((H, 12, B, 2)) * 0.3).astype(np.float32)
    mix[rng.random(mix.shape) < 0.05] = 0.0
    mix[rng.random(mix.shape) < 0.05] = -0.0
    if specials:
        for lane, value, b in ((3, np.nan, B // 2), (5, np.inf, B - 1),
                               (8, -np.inf, 0), (10, np.inf, B // 3)):
            mix[-1, lane, b, lane % 2] = value
        mix[-1, 11, B // 3, 0] = -np.inf
    strips = np.stack([
        rng.uniform(0, 1.2, 11), rng.uniform(0, 1, 11), rng.uniform(0, 1, 11),
        np.concatenate([[-1.0, 1.0], rng.uniform(-1, 1, 9)]),
        (rng.random(11) < 0.2).astype(np.float64)]).astype(np.float32)
    return (torch.from_numpy(mix).to(device),
            torch.from_numpy(strips).to(device))


def _diff(a, b) -> float:
    """Max abs difference over the elements that are not NaN in both."""
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = d[~(torch.isnan(a) & torch.isnan(b))]
    return float(d.max()) if d.numel() else 0.0


def same_bits(a, b) -> bool:
    """Equal with NaN in the same places, every other element bit-equal,
    the sign of zero included."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))
            and torch.equal(torch.signbit(a) & ~nan, torch.signbit(b) & ~nan))


# (V, B, W) of phase 3's voice kernels: the main path's shapes, a ragged B,
# and B=10240 with W = 67 resets (48 kHz: constants.bq_extra_resets)
RENDER_CASES = ((NUM_VOICES, LIVE_BLOCK, 0), (NUM_VOICES, LIVE_BLOCK, 3),
                (NUM_VOICES, SUPER_BLOCK, 0), (NUM_VOICES, SUPER_BLOCK, 3),
                (1000, 130, 3), (LARGE_VOICES, LARGE_BLOCK, 67))
PREP_OUTPUTS = ("pos_local", "alpha", "g", "valid", "win_a", "win_b")
# (H, B) of the finish's checks (phase 3 and the card tests of
# tests/test_torch_kernels.py): the main path's block and horizon shapes,
# ragged B about a warp, a CTA's frames and a master chunk's, the largest
# unsplit tree, and past it the split (R = 2 and 4 classes a lane)
FINISH_CASES = ((1, 1), (1, 31), (1, 33), (1, 64), (1, LIVE_BLOCK),
                (16, LIVE_BLOCK), (1, 130), (16, 130), (1, 255), (1, 257),
                (1, 1000), (1, SUPER_BLOCK), (16, SUPER_BLOCK), (2, 4096),
                (1, 16384), (1, 16385), (1, 16512), (2, 16512), (1, 40000),
                (2, 40000))


def _check_prep(got, want, label: str) -> float:
    err = max(_diff(a, b) for a, b in zip(got, want))
    for name, a, b in zip(PREP_OUTPUTS, got, want):
        check(torch.equal(a, b) and a.is_contiguous(),
              f"voice_prep {name} differs from plain ({label}): {err:.3e}")
    return err


def phase_render_kernels(device) -> dict:
    """The voice prep, voice post and finish kernels against their plain
    versions on the card, torch.equal: the prep on hostile programs at
    RENDER_CASES, from a block's strided columns and from own tensors, and
    slices 1 and H-1 of hostile H=2 and H=16 horizons from their compact
    dynamics (unpack_horizon_slice + the plain prep); the post on the fetch
    kernel's taps of those programs (pan a strided column), also into a
    slice of a stacked buffer and into an 8-byte aligned view; the finish at
    FINISH_CASES (past 16384 frames each lane's tree split over CTAs), each
    also with NaN and +-inf frames (bit-equal with NaN in the same places),
    and one captured finish graph replayed twice. Returns each kernel's max
    abs error over the elements not NaN in both (0)."""
    from libzl_tpu_torch.ops import fetch_windows as fw
    from libzl_tpu_torch.ops import finish as fin
    from libzl_tpu_torch.ops import voice_render as vr

    rng = np.random.default_rng(2468)
    sound = torch.from_numpy((rng.standard_normal((2, 1 << 20)) * 0.3)
                             .astype(np.float32)).to(device)
    worst = dict.fromkeys(RENDER_KERNELS, 0.0)
    for V, B, W in RENDER_CASES:
        prog = render_program(rng, V, B, W, device)
        got = vr.voice_prep(prog, B)
        want = vr.voice_prep_plain(prog, B)
        err = max(_check_prep(got, want, f"V={V} B={B} W={W} strided"),
                  _check_prep(vr.voice_prep(own_columns(prog), B), want,
                              f"V={V} B={B} W={W} own"))
        for H in (2, 16):
            dyn = render_dynamics(rng, V, B, H, W, device)
            for h in sorted({1, H - 1}):
                err = max(err, _check_prep(
                    vr.voice_prep_slice(prog, dyn, h, B),
                    vr.voice_prep_slice_plain(prog, dyn, h, B),
                    f"V={V} B={B} W={W} slice {h} of {H}"))
        torch.cuda.synchronize()
        worst["voice_prep"] = max(worst["voice_prep"], err)
        exp_rows = prog.env.rel_mode == 1
        interp = fw.fetch_interp(sound, got[0], got[1], got[4], got[5])
        args = (interp, got[2], got[3], prog.pan)
        peak, contrib = vr.voice_post(*args)
        want_peak, want_contrib = vr.voice_post_plain(*args)
        buf = torch.full((3, V, B, 2), 7.0, device=device)
        peak2, _ = vr.voice_post(*args, out=buf[1])
        flat = torch.full((2 + V * B * 2,), 7.0, device=device)
        peak3, _ = vr.voice_post(*args, out=flat[2:].view(V, B, 2))
        torch.cuda.synchronize()
        err = max(_diff(contrib, want_contrib), _diff(peak, want_peak))
        check(flat[2:].data_ptr() % 16 == 8, "the view is 16-byte aligned")
        check(torch.equal(contrib, want_contrib)
              and torch.equal(peak, want_peak)
              and torch.equal(buf[1], want_contrib)
              and torch.equal(peak2, want_peak)
              and torch.equal(flat[2:].view(V, B, 2), want_contrib)
              and torch.equal(peak3, want_peak)
              and bool((buf[0] == 7.0).all() and (buf[2] == 7.0).all()
                       and (flat[:2] == 7.0).all()),
              f"voice_post differs from plain at V={V} B={B} W={W}: "
              f"{err:.3e}")
        worst["voice_post"] = max(worst["voice_post"], err)
        check(bool(torch.isfinite(contrib).all()), "non-finite contrib")
        print(f"voice kernels V={V} B={B} W={W}: prep torch.equal to plain "
              f"(strided and own columns, slices 1 and H-1 of H=2 and 16; "
              f"valid frames {int(got[3].sum())} of {V * B}, "
              f"exponential-release voices {int(exp_rows.sum())}), post "
              f"torch.equal (also into a stacked slice and an 8-byte "
              f"aligned view; peak max {float(peak.max()):.4f})")
    for (H, B), specials in itertools.product(FINISH_CASES, (False, True)):
        mix, strips = finish_inputs(rng, H, B, device, specials)
        got = fin.finish(mix, strips)
        want = fin.finish_plain(mix, strips)
        torch.cuda.synchronize()
        err = max(_diff(a, b) for a, b in zip(got, want))
        check(all(same_bits(a, b) for a, b in zip(got, want)),
              f"finish differs from plain at H={H} B={B} "
              f"specials={specials}: {err:.3e}")
        worst["finish_block"] = max(worst["finish_block"], err)
    print(f"finish at (H, B) = {FINISH_CASES}, each with and without NaN, "
          f"+inf and -inf frames: strips, peaks, RMS and master peak "
          f"bit-equal to plain (NaN in the same places, signed zeros)")
    for H, B in ((2, LIVE_BLOCK), (1, 40000)):
        mix, strips = finish_inputs(rng, H, B, device, True)
        want = fin.finish_plain(mix, strips)
        fin.finish(mix, strips)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fin.finish(mix, strips)
        for _ in range(2):
            for out in got:
                out.fill_(7.0)
            graph.replay()
            torch.cuda.synchronize()
            check(all(same_bits(a, b) for a, b in zip(got, want)),
                  f"a replayed finish graph differs from plain at H={H} "
                  f"B={B}")
        print(f"finish H={H} B={B}: one captured graph replayed twice, "
              f"bit-equal to plain both times")
    return worst


def _densest_lane(engine) -> int:
    act = engine.pool.active
    return int(np.bincount(engine.pool.lane[act], minlength=12).max()) \
        if act.any() else 0


def _check_block(og, oc, mix_atol: float, label: str, worst: dict) -> None:
    """One block of a card engine against a "cpu" engine: voice_peaks atol
    2e-6; lane_mix and master rtol 1e-5, atol `mix_atol`; finite, same
    shapes, audible master. Folds the max errors into `worst`."""
    for name, atol, rtol in (("voice_peaks", PEAK_ATOL, 0.0),
                             ("lane_mix", mix_atol, MIX_RTOL),
                             ("master", mix_atol, MIX_RTOL)):
        a = getattr(og, name).cpu().numpy()
        b = getattr(oc, name).cpu().numpy()
        check(a.shape == b.shape and np.isfinite(a).all(),
              f"{label}: {name} shape/finite")
        err = np.abs(a - b)
        worst[name] = max(worst.get(name, 0.0), float(err.max()))
        bad = err > atol + rtol * np.abs(b)
        check(not bad.any(),
              f"{label}: {name} max err {err.max():.3e} "
              f"(atol {atol:.1e}, rtol {rtol:g})")
    check(float(np.abs(og.master.cpu().numpy()).max()) > 0,
          f"{label}: silent master")


def _compare_blocks(gpu, cpu, n_blocks: int, label: str) -> dict:
    worst = {"master": 0.0, "lane_mix": 0.0, "voice_peaks": 0.0}
    for i in range(n_blocks):
        before = _densest_lane(gpu)
        og = gpu.process_block().outputs
        oc = cpu.process_block().outputs
        mix_atol = MIX_ATOL_PER_VOICE * max(before, _densest_lane(gpu), 1)
        _check_block(og, oc, mix_atol, f"{label} block {i}", worst)
    return worst


def phase_slice(device) -> dict:
    from libzl_tpu_torch.engine.engine import AudioEngine

    pairs = []
    for B, n, V in ((SUPER_BLOCK, SLICE_SUPER_BLOCKS, NUM_VOICES),
                    (LIVE_BLOCK, SLICE_LIVE_BLOCKS, NUM_VOICES),
                    (LARGE_BLOCK, LARGE_BLOCKS, LARGE_VOICES)):
        gpu = AudioEngine(device, sample_rate=SAMPLE_RATE, block_frames=B,
                          num_voices=V, **PER_BLOCK)
        cpu = AudioEngine("cpu", sample_rate=SAMPLE_RATE, block_frames=B,
                          num_voices=V, **PER_BLOCK)
        check(gpu.fetch == "windows" and cpu.fetch == "gather",
              f"fetch resolved to {gpu.fetch}/{cpu.fetch}")
        build_session(gpu, num_voices=V)
        build_session(cpu, num_voices=V)
        gpu.warmup()
        pairs.append((B, n, gpu, cpu))
    torch.cuda.synchronize()

    gpus = [g for _, _, g, _ in pairs]
    reset_counts(gpus)
    reset_launches()
    for B, n, gpu, cpu in pairs:
        t0 = time.perf_counter()
        worst = _compare_blocks(gpu, cpu, n, f"B={B}")
        print(f"slice B={B}: {n} blocks, active voices "
              f"{int(gpu.pool.active.sum())}, beat-quantized reset columns "
              f"{gpu.pool.n_bq_extra}, densest lane "
              f"{_densest_lane(gpu)}, max err "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f" ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    launches = read_launches()

    windows = sum(g.fetch_dispatches["windows"] for g in gpus)
    gather = sum(g.fetch_dispatches["gather"] for g in gpus)
    print(f"slice: kernel launches {json.dumps(launches)}, dispatched blocks "
          f"windows {windows} gather {gather}, renders {renders(gpus)}")
    check(gather == 0, "a block fell back to the gather fetch")
    check(windows == SLICE_SUPER_BLOCKS + SLICE_LIVE_BLOCKS + LARGE_BLOCKS,
          f"{windows} dispatched blocks, expected every block")
    check_launches(launches, windows, gpus, "slice")
    return launches


# (B, blocks, note-off block, set_strip block): the first horizon starts
# after 3 clean blocks, the chain is adopted at every exhaustion, and both
# events land mid-horizon at least 3 blocks after the last one, so each
# preempts the horizon and rebuilds it in its event block
DEFAULT_RUNS = ((SUPER_BLOCK, 18, 10, 15), (256, 40, 22, 27),
                (LIVE_BLOCK, 66, 40, 48))
# what "auto" resolves to on a card (PERF.md §5, "Dispatch defaults"): the
# lookahead at each B of DEFAULT_RUNS, the bounce drain
CARD_LOOKAHEAD = {SUPER_BLOCK: 0, 256: 0, LIVE_BLOCK: 16}
CARD_DRAIN = 64


def horizon_runs(B: int) -> list:
    """(label, engine options) of the engines a phase drives at B: the
    default, and where "auto" resolves to the per-block path on the card,
    the horizon engine at the reference's H for B (H=2 at B=1024, 8 at
    B=256) beside it, so every phase still drives a horizon at each B."""
    from libzl_tpu_torch.engine.engine import (_reference_lookahead,
                                               resolve_lookahead)

    runs = [("default", {})]
    H = _reference_lookahead(B)
    if not resolve_lookahead("auto", B, "cuda") and H > 1:
        runs.append((f"lookahead{H}", {"lookahead": H}))
    return runs


def default_engines(device, B: int):
    """(a horizon engine on `device`, the per-block engine with the same
    buckets on `device`, the per-block engine on "cpu"), each
    with the session built; the device engines warmed up. The default
    engine is the first where "auto" resolves to a horizon at B, else the
    second, beside the horizon engine of horizon_runs."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    def make(dev, **opts):
        e = AudioEngine(dev, sample_rate=SAMPLE_RATE, block_frames=B,
                        num_voices=NUM_VOICES, **opts)
        build_session(e)
        return e

    runs = dict(horizon_runs(B))
    if len(runs) == 1:
        hz, pb = make(device), make(device, lookahead=0)
    else:
        (_, opts), = [r for r in runs.items() if r[0] != "default"]
        hz, pb = make(device, **opts), make(device)
    cpu = make("cpu", lookahead=0)
    hz.warmup()
    pb.warmup()
    return hz, pb, cpu


def drive_default(hz, pb, cpu, n: int, off_at: int, strip_at: int) -> dict:
    """Drive the three engines `n` blocks with a note-off at `off_at` and a
    set_strip at `strip_at`; hold `hz` to `cpu` every block (phase 4's
    rule) and measure its difference from `pb`. Ends with the speculation
    drained, so every render the engines started has been enqueued."""
    worst, worst_pb = {}, 0.0
    preempted = rebuilt = 0
    for i in range(n):
        if i == off_at:
            for e in (hz, pb, cpu):
                note_off(e, 5)
        if i == strip_at:
            for e in (hz, pb, cpu):
                e.set_strip(2, dry=0.7, pan=-0.3)
        mid = hz._h_cursor < len(hz._h_slices)
        before = _densest_lane(cpu)
        oh = hz.process_block().outputs
        op = pb.process_block().outputs
        oc = cpu.process_block().outputs
        if mid and hz._blocks_since_event == 0:
            preempted += 1
            rebuilt += int(hz._h_built_this_block)
        mix_atol = MIX_ATOL_PER_VOICE * max(before, _densest_lane(cpu), 1)
        _check_block(oh, oc, mix_atol, f"B={hz.block_frames} block {i}",
                     worst)
        for a, b in zip(oh, op):
            worst_pb = max(worst_pb, float((a - b).abs().max()))
    hz.drain_speculation()
    kinds = hz.stats()["slo_by_kind"]
    return dict(worst=worst, worst_pb=worst_pb, preempted=preempted,
                rebuilt=rebuilt,
                horizons=kinds.get("horizon", [0, 0])[1],
                adoptions=kinds.get("adopt", [0, 0])[1],
                rebuilds=kinds.get("event_rebuild", [0, 0])[1])


def phase_default_engine(device) -> dict:
    runs = []
    for B, n, off_at, strip_at in DEFAULT_RUNS:
        hz, pb, cpu = default_engines(device, B)
        default = hz if CARD_LOOKAHEAD[B] else pb
        check(default._lookahead == CARD_LOOKAHEAD[B] and hz._lookahead > 1
              and default.fetch == "windows"
              and default._bucket_ladder == [64, 128, 256, 512, 1024],
              f"default options at B={B} resolved to lookahead "
              f"{default._lookahead} (want {CARD_LOOKAHEAD[B]}), fetch "
              f"{default.fetch}, buckets {default._bucket_ladder}")
        runs.append((B, n, off_at, strip_at, hz, pb, cpu))
    torch.cuda.synchronize()
    total = {}
    for B, n, off_at, strip_at, hz, pb, cpu in runs:
        reset_counts((hz, pb))
        t0 = time.perf_counter()
        reset_launches()
        r = drive_default(hz, pb, cpu, n, off_at, strip_at)
        torch.cuda.synchronize()
        launches = read_launches()
        windows = hz.fetch_dispatches["windows"] + pb.fetch_dispatches[
            "windows"]
        gather = hz.fetch_dispatches["gather"] + pb.fetch_dispatches["gather"]
        stats = hz.stats()
        print(f"default B={B} H={CARD_LOOKAHEAD[B]}"
              + (f", horizon engine H={hz._lookahead}"
                 if not CARD_LOOKAHEAD[B] else "")
              + f": {n} blocks, horizons "
              f"{r['horizons']}, adoptions {r['adoptions']}, event rebuilds "
              f"{r['rebuilds']}, preemptions {r['preempted']} (rebuilt "
              f"{r['rebuilt']}); vs cpu max err "
              + ", ".join(f"{k} {v:.3e}" for k, v in r["worst"].items())
              + f"; vs cuda lookahead=0"
              + (" (the default)" if not CARD_LOOKAHEAD[B] else "")
              + f" max |diff| {r['worst_pb']:.3e}"
              f"{' (bit-equal)' if r['worst_pb'] == 0.0 else ''}; kernel "
              f"launches {json.dumps(launches)}, rendered blocks windows "
              f"{windows} (horizon engine {hz.fetch_dispatches['windows']}) "
              f"gather {gather}, renders {renders((hz, pb))} "
              f"({json.dumps(hz.render_dispatches)} + "
              f"{json.dumps(pb.render_dispatches)}); spec failures "
              f"{stats['spec_failures']} ({time.perf_counter() - t0:.1f} s)")
        check(stats["spec_failures"] == 0,
              f"speculative build failed: {stats['spec_last_failure']}")
        check(r["worst_pb"] == 0.0, f"B={B} H={hz._lookahead}: differs "
              f"from lookahead=0 by {r['worst_pb']:.3e}")
        check(r["horizons"] >= 1 and r["adoptions"] >= 2,
              f"B={B}: {r['horizons']} horizons, {r['adoptions']} adoptions")
        check(r["preempted"] >= 2 and r["rebuilt"] >= 2,
              f"B={B}: {r['preempted']} preemptions, {r['rebuilt']} rebuilt")
        check(gather == 0, "a block fell back to the gather fetch")
        check_launches(launches, windows, (hz, pb), f"default B={B}")
        total = add_launches(total, launches)
    return total


def _device_profile(engine, n_blocks: int) -> dict:
    """Device time per block from torch.profiler's CUDA kernel events over
    `n_blocks` chained blocks, the speculation drained before the profiler
    stops: total, kernel launches, and the shares of the fetch and mixdown
    kernels. Empty when the profiler sees no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    renders0 = dict(engine.render_dispatches)
    kinds0 = {k: v[1] for k, v in engine.stats()["slo_by_kind"].items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_blocks):
            engine.process_block()
        # no graph replay on the spec dispatch thread while the profiler
        # stops: that stop deadlocks against a graph launch on another
        # thread (AudioEngine.capture_trace)
        engine.drain_speculation()
        torch.cuda.synchronize()
    renders = {k: v - renders0[k]
               for k, v in engine.render_dispatches.items()}
    kinds = {k: v[1] - kinds0.get(k, 0)
             for k, v in engine.stats()["slo_by_kind"].items()
             if v[1] > kinds0.get(k, 0)}
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in dev)
    if device_us <= 0:
        return {}
    def share(name):
        return sum(e.self_device_time_total for e in dev
                   if name in e.key) / device_us

    return {
        "device_ms": device_us / n_blocks / 1e3,
        "kernels": sum(e.count for e in dev) / n_blocks,
        # what the window ran: its blocks by dispatch kind (per_block, or
        # horizon / adopt / spec / emit ...) and its renders (block,
        # horizon; a speculative render included), so kernels a render
        "blocks": n_blocks,
        "block_kinds": kinds,
        "renders": renders,
        "fetch_share": share("fetch_interp_kernel"),
        "mixdown_share": share("lane_mixdown_kernel"),
        **{f"{name}_share": share(f"{name}_kernel")
           for name in RENDER_KERNELS},
    }


def _print_profile(card: str, label: str, prof: dict, block_ms: float):
    if not prof:
        print(f"[{card}] {label} device profile: not measured (no device "
              f"events in the profiler)")
        return
    print(f"[{card}] {label} device profile: {prof['device_ms']:.4f} ms "
          f"device per block, {prof['kernels']:.1f} kernels per block; "
          f"shares of device time: "
          + ", ".join(f"{name} {100 * prof[f'{name}_share']:.2f}%"
                      for name in ("voice_prep", "fetch", "voice_post",
                                   "mixdown", "finish_block"))
          + f"; device busy {100 * prof['device_ms'] / block_ms:.1f}% of "
          f"the unprofiled process_block time ({block_ms:.4f} ms); the "
          f"window's {prof['blocks']} blocks by kind "
          f"{json.dumps(prof['block_kinds'])}, renders "
          f"{json.dumps(prof['renders'])}, "
          + (f"{prof['kernels'] * prof['blocks'] / n:.1f} kernels a render"
             if (n := sum(prof['renders'].values())) else "no render"))


def capture_dispatch(engine) -> dict:
    """Every kernel call of one more block of a one-device per-block engine
    (the session's last per-block dispatch), one of each: bench.capture_calls'
    record."""
    with eager_renders(engine):
        calls = bench.capture_calls(engine.process_block)
    torch.cuda.synchronize()
    check(all(len(c) == 1 for c in calls.values()),
          f"kernel calls in one block: "
          f"{ {k: len(c) for k, c in calls.items()} }")
    return calls


def time_render_kernels(device, card: str, res: dict, session: dict,
                        versions: dict) -> None:
    """The voice prep, voice post and finish kernels, their plain versions
    and the --compare sources of each (`versions`: {kernel: {name: fn}})
    in turns (each, then each in reverse; p50 of 50 CUDA-event timings each,
    L2 flushed, queued behind a spin) on the session's last per-block
    dispatch at B=1024 and B=128 (`session`: capture_dispatch's record by
    B); the voice prep also on slice 1 of a horizon over that program (an
    H=2 dynamics of render_dynamics' draws; no --compare source before this
    one reads slices), and the finish on a stacked H=16 horizon at B=128
    and on one block of 16512 and 40000 frames (the split tree);
    each beside its bound (utils/roofline). Keys `<name>_{kernel,plain,
    bound}_ms_<case>`, `<name>_<version>_ms_<case>` and
    `<name>_bound_by_<case>`."""
    from libzl_tpu_torch.ops import finish as fin
    from libzl_tpu_torch.ops import voice_render as vr
    from libzl_tpu_torch.utils import roofline as rl

    rng = np.random.default_rng(98)
    cases = {}   # (name, key) -> (kernel, plain, bound, versions' args)
    for B, calls in session.items():
        key = f"{NUM_VOICES}x{B}_session"
        prep, = calls["voice_prep"]
        post, = calls["voice_post"]
        fin_args, = calls["finish"]
        cases[("voice_prep", key)] = (
            lambda prep=prep: vr.voice_prep(*prep),
            lambda prep=prep: vr.voice_prep_plain(*prep),
            rl.voice_prep_bound(*prep[:2]), prep)
        prog, b, ratio = prep
        sl = (prog, render_dynamics(rng, NUM_VOICES, b, 2,
                                    prog.bq_reset.shape[1], device), 1, b,
              ratio)
        cases[("voice_prep", key + "_slice")] = (
            lambda sl=sl: vr.voice_prep_slice(*sl),
            lambda sl=sl: vr.voice_prep_slice_plain(*sl),
            rl.voice_prep_slice_bound(*sl[:4]), None)
        cases[("voice_post", key)] = (
            lambda post=post: vr.voice_post(*post),
            lambda post=post: vr.voice_post_plain(*post),
            rl.voice_post_bound(*post), post)
        cases[("finish_block", key)] = (
            lambda f=fin_args: fin.finish(*f),
            lambda f=fin_args: fin.finish_plain(*f),
            rl.finish_bound(*fin_args), fin_args)
    for H, B, key in ((16, LIVE_BLOCK, f"16x{LIVE_BLOCK}_horizon"),
                      (1, 16512, "1x16512_split"),
                      (1, 40000, "1x40000_split")):
        args = finish_inputs(rng, H, B, device)
        cases[("finish_block", key)] = (
            lambda a=args: fin.finish(*a),
            lambda a=args: fin.finish_plain(*a), rl.finish_bound(*args), args)
    for (name, key), (kernel, plain, bound, args) in cases.items():
        fns = {"kernel": kernel, "plain": plain}
        want = plain()
        for vname, fn in (versions.get(name, {}) if args else {}).items():
            fns[vname] = lambda fn=fn, args=args: fn(*args)
            got = fns[vname]()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{name} {key}: version {vname} differs from plain")
        for f in fns.values():
            for _ in range(5):
                f()
        names = list(fns)
        samples = {n: [] for n in names}
        for n in names + names[::-1]:
            samples[n] += _events_ms(fns[n], 25, True)
        ms = {n: float(np.median(v)) for n, v in samples.items()}
        for n in names:
            res[f"{name}_{n}_ms_{key}"] = ms[n]
        res[f"{name}_bound_ms_{key}"] = bound["bound_ms"]
        res[f"{name}_bound_by_{key}"] = bound["bound_by"]
        print(f"[{card}] {name} {key}: "
              + ", ".join(f"{n} {ms[n]:.4f} ms" for n in names)
              + f" (p50 of 50 CUDA-event timings each, in turns); bound "
              f"{bound['bound_ms']:.5f} ms ({bound['bytes']} bytes, "
              f"{bound['bound_by']}): the kernel reaches "
              f"{100 * bound['bound_ms'] / ms['kernel']:.1f}% of it"
              + "".join(f", {n} {100 * bound['bound_ms'] / ms[n]:.1f}%"
                        for n in names[2:]))


def time_mixdown(card: str, res: dict, key: str, contrib, lane,
                 versions: dict) -> None:
    """The mixdown kernel (16-byte copy chunks at these shapes), the same
    through 8- and 4-byte chunks (copy8, copy4), the --compare versions, its
    plain version, the one-hot torch.matmul it replaces (one call, the
    one-hot built beforehand; another summation order) and an empty kernel
    on the kernel's grid (what the launch alone costs) on the same inputs:
    p50 of 50 CUDA-event timings each, in turns, beside the bound; into
    res["mix_<name>_ms_<key>"]."""
    from libzl_tpu_torch import _build
    from libzl_tpu_torch.ops import mixdown as md

    lib = _build.load()
    V, B = contrib.shape[-3], contrib.shape[-2]
    H = contrib.shape[0] if contrib.dim() == 4 else 1
    onehot = (torch.arange(12, device=lane.device)[:, None]
              == lane.long()[None, :]).to(torch.float32)
    flat = contrib.reshape(*contrib.shape[:-3], V, -1)
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        _build.check(lib, lib.zl_lane_mixdown_empty(H, 2 * B, 12, stream),
                     "empty launch")

    fns = {"kernel": lambda: md.lane_mixdown(contrib, lane)}
    for vec in (2, 1):
        fns[f"copy{4 * vec}"] = lambda vec=vec: md.launch_kernel(
            contrib, lane, vec=vec)
    for name, mix in versions.items():
        fns[name] = lambda mix=mix: mix(contrib, lane)
    fns["plain"] = lambda: md.lane_mixdown_plain(contrib, lane)
    fns["library"] = lambda: torch.matmul(onehot, flat)
    want = fns["plain"]()
    for name in ("kernel", "copy8", "copy4", *versions):
        check(torch.equal(fns[name](), want),
              f"mixdown {key}: {name} differs from plain")
    lib_err = float((fns["library"]().reshape(want.shape) - want).abs().max())
    fns["empty"] = empty
    for f in fns.values():
        for _ in range(5):
            f()
    names = list(fns)
    samples = {name: [] for name in names}
    for name in names + names[::-1]:
        samples[name] += _events_ms(fns[name], 25, True)
    for name in names:
        res[f"mix_{name}_ms_{key}"] = float(np.median(samples[name]))
    # the kernel again with its inputs left in L2: what the bytes' way from
    # device memory costs it
    res[f"mix_kernel_in_l2_ms_{key}"] = float(np.median(
        _events_ms(fns["kernel"], 50, True, flush_l2=False)))
    bound = mixdown_bound(contrib, lane)
    res[f"mix_bound_ms_{key}"] = bound["bound_ms"]
    res[f"mix_bound_by_{key}"] = bound["bound_by"]
    res[f"mix_bytes_{key}"] = bound["bytes"]
    kernel_ms = res[f"mix_kernel_ms_{key}"]
    print(f"[{card}] mixdown {key} {tuple(contrib.shape)}: device time "
          + ", ".join(f"{name} {res[f'mix_{name}_ms_{key}']:.4f} ms"
                      for name in names)
          + f" (p50 of 50 CUDA-event timings each, in turns; the plain "
          f"version syncs once for its step count), the kernel with its "
          f"inputs in L2 "
          f"{res[f'mix_kernel_in_l2_ms_{key}']:.4f} ms; {bound['bytes']} "
          f"bytes -> bound "
          f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}, 3.35 TB/s); the "
          f"kernel reaches {100 * bound['bound_ms'] / kernel_ms:.1f}% of its "
          f"bound ({bound['bytes'] / 1e6 / kernel_ms:.0f} GB/s); the "
          f"matmul's order differs from the fold by {lib_err:.3e} at most")


def time_mixdowns(device, card: str, res: dict, session_mix: dict,
                  versions: dict) -> None:
    """time_mixdown at the main path's shapes: `session_mix[B]`'s (contrib,
    lane, init) at B=1024 and B=128, and a stacked H=16 horizon at B=128
    (random contributions on those lanes)."""
    for B in (SUPER_BLOCK, LIVE_BLOCK):
        contrib, lane, _ = session_mix[B]
        time_mixdown(card, res, f"{NUM_VOICES}x{B}_session", contrib, lane,
                     versions)
    lane = session_mix[LIVE_BLOCK][1]
    stacked = torch.from_numpy((0.3 * np.random.default_rng(8).standard_normal(
        (16, NUM_VOICES, LIVE_BLOCK, 2))).astype(np.float32)).to(device)
    time_mixdown(card, res, f"16x{NUM_VOICES}x{LIVE_BLOCK}_stacked", stacked,
                 lane, versions)


def _version_render(name: str, lib):
    """(kind, launcher) for a source of the voice prep, voice post or finish
    (this commit's or an earlier one's C entry points), or None: a function
    with the wrapper's arguments that launches it, counting nothing."""
    from libzl_tpu_torch import _build
    from libzl_tpu_torch.ops import voice_render as vr
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def done(code, what):
        # the kernels' library names the error (a single source has no
        # zl_cuda_error_string of its own)
        _build.check(_build.load(), code, f"{what} version {name}")

    if hasattr(lib, "zl_voice_prep"):
        # since the slice source: the window anchors among the outputs
        n_out = 6 if hasattr(lib, "zl_voice_prep_slice") else 4
        lib.zl_voice_prep.argtypes = [ptr, i64, i64, *[ptr] * n_out, i64,
                                      i64, i64, ptr]

        def prep(prog, B, max_pitch_ratio=4.0):
            cols, S, W = vr.prep_columns(prog)
            V, dev = prog.active.shape[0], prog.active.device
            out = [torch.empty((V, B), dtype=t, device=dev)
                   for t in (torch.int32, torch.float32, torch.float32,
                             torch.bool)]
            out += [torch.empty((V,), dtype=torch.int32, device=dev)
                    for _ in range(n_out - 4)]
            done(lib.zl_voice_prep(ctypes.byref(cols), S, W,
                                   *(t.data_ptr() for t in out), V, B,
                                   region_rows(B, max_pitch_ratio),
                                   stream()), "voice_prep")
            return tuple(out)

        return "voice_prep", prep
    if hasattr(lib, "zl_voice_post"):
        lib.zl_voice_post.argtypes = [ptr, ptr, ptr, ptr, i64, ptr, ptr, i64,
                                      i64, ptr]

        def post(interp, g, valid, pan, out=None):
            V, B = interp.shape[0], interp.shape[2]
            if out is None:
                out = torch.empty((V, B, 2), device=interp.device)
            peak = torch.empty((V,), device=interp.device)
            done(lib.zl_voice_post(
                interp.data_ptr(), g.data_ptr(), valid.data_ptr(),
                pan.data_ptr(), pan.stride(0), out.data_ptr(),
                peak.data_ptr(), V, B, stream()), "voice_post")
            return peak, out

        return "voice_post", post
    if hasattr(lib, "zl_finish_block"):
        # since the split tree: the scratch before H
        split = hasattr(lib, "zl_finish_block_scratch")
        lib.zl_finish_block.argtypes = [ptr] * (6 if split else 5) + [
            i64, i64, i64, ptr]
        if split:
            lib.zl_finish_block_scratch.argtypes = [i64, i64, i64]
            lib.zl_finish_block_scratch.restype = i64

        def finish(mix, strips):
            H, L, B = mix.shape[:3]
            out = torch.empty((3, H, L - 1, B, 2), device=mix.device)
            meters = torch.empty((2, H, L, 2), device=mix.device)
            peak = torch.empty((H, 2), device=mix.device)
            scratch = ([torch.empty(
                (max(lib.zl_finish_block_scratch(H, L, B), 1),),
                device=mix.device).data_ptr()] if split else [])
            done(lib.zl_finish_block(
                mix.data_ptr(), strips.data_ptr(), out.data_ptr(),
                meters.data_ptr(), peak.data_ptr(), *scratch, H, L, B,
                stream()), "finish_block")
            return out[0], out[1], out[2], meters[0], meters[1], peak

        return "finish_block", finish
    return None


def load_version(spec: str) -> tuple:
    """`name=path.cu[,nvcc flag,...]`: another source of one of the kernels
    (a parent commit's copy, say), built with the port's nvcc flags plus the
    given ones into build/libzl_tpu_torch/versions/. Returns (name, which
    kernel its C entry points are: "fetch", "mixdown", "voice_prep",
    "voice_post" or "finish_block", a function with that kernel's wrapper's
    arguments that launches it, counting nothing)."""
    from libzl_tpu_torch import _build
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    name, rest = spec.split("=", 1)
    path, *flags = rest.split(",")
    src = Path(path).resolve()
    so = _build._hashed(f"version_{name}", [src], _build.NVCC_FLAGS + flags,
                        _build.BUILD_DIR / "versions")
    if not so.is_file():
        nvcc = _build.find_nvcc()
        _build._compile(lambda out: [nvcc, *_build.NVCC_FLAGS, *flags, "-o",
                                     out, str(src)], so, f"nvcc {name}")
    lib = ctypes.CDLL(str(so))
    print(f"version {name}: {src}{' ' + ' '.join(flags) if flags else ''}")
    render = _version_render(name, lib)
    if render is not None:
        return (name, *render)
    if hasattr(lib, "zl_lane_mixdown"):
        _build.bind_mixdown(lib)

        def mixdown(contrib, lane, init=None):
            c = contrib if contrib.dim() == 4 else contrib[None]
            H, V, B = c.shape[0], c.shape[1], c.shape[2]
            out = torch.empty((H, 12, B, 2), dtype=torch.float32,
                              device=c.device)
            code = lib.zl_lane_mixdown(
                c.data_ptr(), lane.data_ptr(), V if lane.dim() == 2 else 0,
                None if init is None else init.data_ptr(), out.data_ptr(),
                H, V, 2 * B, 12, torch.cuda.current_stream().cuda_stream)
            # the kernels' library names the error (the source has no
            # zl_cuda_error_string of its own)
            _build.check(_build.load(), code, f"mixdown version {name}")
            return out if contrib.dim() == 4 else out[0]

        return name, "mixdown", mixdown
    _build.bind_fetch(lib)

    def fetch(sound, pos, alpha, win_a, win_b, r_max: float = 4.0):
        V, B = pos.shape
        out = torch.empty((V, 2, B), dtype=torch.float32, device=sound.device)
        fn = (lib.zl_fetch_interp_i16 if sound.dtype == torch.int16
              else lib.zl_fetch_interp_f32)
        code = fn(sound.data_ptr(), sound.shape[1], pos.data_ptr(),
                  alpha.data_ptr(), win_a.data_ptr(), win_b.data_ptr(),
                  out.data_ptr(), V, B, region_rows(B, r_max),
                  torch.cuda.current_stream().cuda_stream)
        _build.check(lib, code, f"fetch version {name}")
        return out

    return name, "fetch", fetch


def phase_timing(device, card: str, versions: dict, mix_versions: dict,
                 render_versions: dict) -> dict:
    from libzl_tpu_torch.engine.engine import AudioEngine
    from libzl_tpu_torch.ops import fetch_windows as fw

    res = {}
    # superblock realtime factor: blocks chained, one sync at the end
    eng = AudioEngine(device, sample_rate=SAMPLE_RATE,
                      block_frames=SUPER_BLOCK, num_voices=NUM_VOICES,
                      **PER_BLOCK)
    build_session(eng)
    eng.warmup()
    for _ in range(10):
        eng.process_block()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        n = 40
        t0 = time.perf_counter()
        for _ in range(n):
            out = eng.process_block()
        out.outputs.master.cpu()
        rounds.append(n * SUPER_BLOCK / SAMPLE_RATE
                      / (time.perf_counter() - t0))
    res["rt_superblock"] = float(np.median(rounds))
    res["rt_superblock_rounds"] = rounds
    prof = eng.profiler.summary()
    res["super_host_program_ms_p50"] = prof["host_program"]["p50_ms"]
    res["super_dispatch_ms_p50"] = prof["dispatch"]["p50_ms"]
    res["super_process_block_ms_p50"] = prof["process_block"]["p50_ms"]
    super_profile = _device_profile(eng, 20)
    calls = {SUPER_BLOCK: capture_dispatch(eng)}
    print(f"[{card}] superblock realtime factor {res['rt_superblock']:.3f}x "
          f"(rounds {', '.join(f'{r:.3f}' for r in rounds)}; 1024 voices, "
          f"64 clips, B=1024, 48 kHz)")

    # live blocks: chained (no per-block sync), one sync at the end
    live = AudioEngine(device, sample_rate=SAMPLE_RATE,
                       block_frames=LIVE_BLOCK, num_voices=NUM_VOICES,
                       **PER_BLOCK)
    build_session(live)
    live.warmup()
    for _ in range(20):
        live.process_block()
    torch.cuda.synchronize()
    n = 300
    per_block = []
    t0 = time.perf_counter()
    for _ in range(n):
        t1 = time.perf_counter()
        out = live.process_block()
        per_block.append((time.perf_counter() - t1) * 1e3)
    out.outputs.master.cpu()
    total = (time.perf_counter() - t0) * 1e3
    res["live_ms_p50"] = float(np.median(per_block))
    res["live_ms_chained_mean"] = total / n
    res["rt_liveblock"] = LIVE_BLOCK / SAMPLE_RATE * 1e3 / (total / n)
    lprof = live.profiler.summary()
    res["live_host_program_ms_p50"] = lprof["host_program"]["p50_ms"]
    res["live_dispatch_ms_p50"] = lprof["dispatch"]["p50_ms"]
    live_profile = _device_profile(live, 40)
    calls[LIVE_BLOCK] = capture_dispatch(live)
    session = {B: c["fetch"][0] for B, c in calls.items()}
    session_mix = {B: c["mixdown"][0] for B, c in calls.items()}
    print(f"[{card}] live block (B=128, 1024 voices) ms/block p50 "
          f"{res['live_ms_p50']:.4f} chained mean "
          f"{res['live_ms_chained_mean']:.4f} (realtime "
          f"{res['rt_liveblock']:.3f}x); host program p50 "
          f"{res['live_host_program_ms_p50']:.4f} ms, dispatch p50 "
          f"{res['live_dispatch_ms_p50']:.4f} ms")
    print(f"[{card}] superblock host program p50 "
          f"{res['super_host_program_ms_p50']:.4f} ms, dispatch p50 "
          f"{res['super_dispatch_ms_p50']:.4f} ms, process_block p50 "
          f"{res['super_process_block_ms_p50']:.4f} ms")
    from libzl_tpu_torch.engine.graphs import DISPATCH_SPANS

    for B, p in ((SUPER_BLOCK, prof), (LIVE_BLOCK, lprof)):
        parts = {name: p[name]["p50_ms"] for name in DISPATCH_SPANS
                 if name in p}
        res[f"dispatch_parts_{B}"] = parts
        print(f"[{card}] per-block engine B={B} dispatch p50 "
              f"{p['dispatch']['p50_ms']:.4f} ms; a replay's parts p50: "
              + ", ".join(f"{name[9:]} {ms:.4f}" for name, ms in
                          parts.items())
              + f" ms; the rest of dispatch (bucket, envelope, fuse, key) "
              f"~{p['dispatch']['p50_ms'] - sum(parts.values()):.4f} ms")
    _print_profile(card, "superblock", super_profile,
                   res["super_process_block_ms_p50"])
    _print_profile(card, "live block", live_profile,
                   lprof["process_block"]["p50_ms"])
    res.update({f"super_profile_{k}": v for k, v in super_profile.items()})
    res.update({f"live_profile_{k}": v for k, v in live_profile.items()})
    for B, prof in ((SUPER_BLOCK, super_profile), (LIVE_BLOCK, live_profile)):
        ms, kernels = PLAIN_BODY_DEVICE[B]
        print(f"[{card}] per-block engine B={B}, graphs: "
              + (f"{prof['device_ms']:.4f} ms of device and "
                 f"{prof['kernels']:.1f} kernels a block"
                 if prof else "device time not measured")
              + f" (before the voice kernels: {ms} ms, "
              f"{kernels} kernels)")

    _default_timing(device, card, res)

    # fetch kernel vs plain version (and the --compare versions) at the main
    # path's shapes, in turns, on synthetic engine-like inputs and on the
    # session's last per-block dispatch; beside each, the bound from the
    # call's own inputs
    rng = np.random.default_rng(99)
    for V, B in ((NUM_VOICES, LIVE_BLOCK), (NUM_VOICES, SUPER_BLOCK)):
        cases = {
            "synthetic": (kernel_inputs(rng, V, B, BANK_FRAMES,
                                        torch.float32, False, device), 4.0),
            "session": session[B],
        }
        for label, (args, r_max) in cases.items():
            fns = {"plain": lambda: fw.fetch_interp_plain(*args,
                                                          r_max=r_max),
                   "kernel": lambda: fw.fetch_interp(*args, r_max=r_max)}
            want = fns["plain"]()
            for name, fetch in versions.items():
                fns[name] = lambda fetch=fetch: fetch(*args, r_max=r_max)
                err = float((fns[name]() - want).abs().max())
                check(err <= FETCH_ATOL,
                      f"version {name} disagrees with plain: {err}")
            for f in fns.values():
                for _ in range(5):
                    f()
            bound = fetch_bound(args, r_max)
            key = f"{V}x{B}_{label}"
            res[f"bound_ms_{key}"] = bound["bound_ms"]
            res[f"bytes_{key}"] = bound["bytes"]
            res[f"bound_by_{key}"] = bound["bound_by"]
            names = list(fns)
            for primed, tag in ((True, ""), (False, "call_")):
                samples = {name: [] for name in names}
                for name in names + names[::-1]:
                    samples[name] += _events_ms(fns[name], 25, primed)
                ms = {name: float(np.median(samples[name]))
                      for name in names}
                for name in names:
                    res[f"{name}_{tag}ms_{key}"] = ms[name]
                what = ("device time" if primed
                        else "call time incl. host launch latency")
                print(f"[{card}] fetch V={V} B={B} {label} "
                      f"({str(args[0].dtype)[6:]} bank, r_max {r_max:g}) "
                      f"{what}: "
                      + ", ".join(f"{name} {ms[name]:.4f} ms"
                                  for name in ["kernel", "plain",
                                               *versions])
                      + " (p50 of 50 CUDA-event timings each, in turns)")
            print(f"[{card}] fetch V={V} B={B} {label}: "
                  f"{bound['valid_frames']} valid frames, "
                  f"{bound['unique_taps']} unique taps, {bound['bytes']} "
                  f"bytes -> bound {bound['bound_ms']:.5f} ms "
                  f"({bound['bound_by']}, 3.35 TB/s); the kernel reaches "
                  f"{100 * bound['bound_ms'] / res[f'kernel_ms_{key}']:.1f}% "
                  f"of its bound ("
                  f"{bound['bytes'] / 1e6 / res[f'kernel_ms_{key}']:.0f} "
                  f"GB/s)"
                  + "".join(f"; {name} {100 * bound['bound_ms'] / ms:.1f}%"
                            for name in versions
                            for ms in [res[f"{name}_ms_{key}"]]))

    time_mixdowns(device, card, res, session_mix, mix_versions)
    time_render_kernels(device, card, res, calls, render_versions)
    torch.cuda.synchronize()
    return res


def _spans(engine) -> dict:
    prof = engine.profiler.summary()
    return {name: {k: prof[name][k] for k in ("p50_ms", "max_ms", "count")}
            for name in ("process_block", "horizon_build", "adopt_wait",
                         "emit") if name in prof}


def _default_timing(device, card: str, res: dict) -> None:
    """The default engine (horizon, chain, buckets) at both
    geometries, and the horizon engine beside it where the default is the
    per-block path (horizon_runs): realtime factor and ms/block over
    chained blocks (one sync at the end), SLO misses per kind, DSP load,
    the lookahead spans, a device profile; at B=128 also a paced run of
    the default engine, one block per period."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    def engine(B, **opts):
        e = AudioEngine(device, sample_rate=SAMPLE_RATE, block_frames=B,
                        num_voices=NUM_VOICES, **opts)
        build_session(e)
        e.warmup()
        for _ in range(3 + 4 * e._lookahead):   # past the first adoptions
            e.process_block()
        torch.cuda.synchronize()
        return e

    for B, n, rounds_n, label, opts in (
            (B, n, r, label, opts)
            for B, n, r in ((SUPER_BLOCK, 40, 3), (LIVE_BLOCK, 320, 1))
            for label, opts in horizon_runs(B)):
        e = engine(B, **opts)
        tag = f"{label}_{B}"
        rts, per_block = [], []
        for _ in range(rounds_n):
            t0 = time.perf_counter()
            for _ in range(n):
                t1 = time.perf_counter()
                out = e.process_block()
                per_block.append((time.perf_counter() - t1) * 1e3)
            out.outputs.master.cpu()
            rts.append(n * B / SAMPLE_RATE / (time.perf_counter() - t0))
        stats = e.stats()
        res[f"{tag}_rt"] = float(np.median(rts))
        res[f"{tag}_rt_rounds"] = rts
        res[f"{tag}_ms_p50"] = float(np.median(per_block))
        res[f"{tag}_ms_mean"] = float(np.mean(per_block))
        res[f"{tag}_slo_by_kind"] = stats["slo_by_kind"]
        res[f"{tag}_dsp_load"] = stats["dsp_load"]
        res[f"{tag}_spans"] = _spans(e)
        res[f"{tag}_spec_failures"] = stats["spec_failures"]
        prof = _device_profile(e, 4 * e._lookahead or 16)
        res.update({f"{tag}_profile_{k}": v for k, v in prof.items()})
        print(f"[{card}] {label} engine B={B} H={e._lookahead}: realtime "
              f"factor {res[f'{tag}_rt']:.3f}x (rounds "
              f"{', '.join(f'{r:.3f}' for r in rts)}), process_block ms p50 "
              f"{res[f'{tag}_ms_p50']:.4f} mean {res[f'{tag}_ms_mean']:.4f} "
              f"(chained, {rounds_n}x{n} blocks); dsp_load "
              f"{stats['dsp_load']}; spec failures {stats['spec_failures']}")
        print(f"[{card}] {label} engine B={B} slo_by_kind (missed, total, "
              f"worst overrun ms): {json.dumps(stats['slo_by_kind'])}")
        print(f"[{card}] {label} engine B={B} spans: "
              f"{json.dumps(res[f'{tag}_spans'])}")
        # emits make the p50 tiny: the busy share is over the mean
        _print_profile(card, f"{label} engine B={B} H={e._lookahead}", prof,
                       res[f"{tag}_ms_mean"])
        check(stats["spec_failures"] == 0,
              f"speculative build failed: {stats['spec_last_failure']}")
        e.drain_speculation()

    # paced live run: one block per 2.667 ms period, as a realtime pump
    # would call it; the lag says whether the engine keeps up
    from libzl_tpu_torch.utils.profiling import SloCounter

    e = engine(LIVE_BLOCK)
    period = LIVE_BLOCK / SAMPLE_RATE
    e.slo = SloCounter(budget_seconds=period)   # count this run only
    n = 384
    t0 = time.perf_counter()
    for i in range(n):
        wait = t0 + i * period - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        out = e.process_block()
    out.outputs.master.cpu()
    lag = (time.perf_counter() - t0 - n * period) * 1e3
    stats = e.stats()
    res["paced_128_slo_by_kind"] = stats["slo_by_kind"]
    res["paced_128_lag_ms"] = lag
    res["paced_128_spans"] = _spans(e)
    emits = stats["slo_by_kind"].get("emit", [0, 0, 0.0])
    print(f"[{card}] default engine B=128 paced ({n} blocks, one per "
          f"{period * 1e3:.3f} ms): lag behind the schedule at the end "
          f"{lag:.1f} ms; emit blocks within 2.667 ms "
          f"{emits[1] - emits[0]} of {emits[1]}; slo_by_kind "
          f"{json.dumps(stats['slo_by_kind'])}; spans "
          f"{json.dumps(res['paced_128_spans'])}")
    e.drain_speculation()


# ------------------------------------------------- render graphs (16)

GRAPH_SESSION_BLOCKS = 384
GRAPH_MODES = ("auto", "off", "off", "auto")   # in turns


def graph_engine(device, B: int, **opts):
    """A default engine (or `opts`) on `device` with the session built."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    e = AudioEngine(device, sample_rate=SAMPLE_RATE, block_frames=B,
                    num_voices=NUM_VOICES, **opts)
    build_session(e)
    return e


def measured_warmup(e) -> dict:
    """warmup() with its wall seconds, the graphs it left and the growth of
    torch.cuda.memory_reserved across it."""
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    e.warmup()
    torch.cuda.synchronize()
    stats = e.stats()
    return dict(warmup_s=time.perf_counter() - t0, graphs=stats["graphs"],
                capture_s=stats["graph_capture_s"],
                graph_bytes=stats["graph_bytes"],
                reserved_growth=torch.cuda.memory_reserved() - reserved)


def session_programs(e, n: int) -> dict:
    """{kind: the last host program of that kind} of `n` more blocks."""
    seen, real = {}, e._render

    def spy(kind, fetch, prog, *a, **k):
        seen[kind] = prog.copy()
        return real(kind, fetch, prog, *a, **k)

    e._render = spy
    try:
        for _ in range(n):
            e.process_block()
        e.drain_speculation()
    finally:
        del e._render
    return seen


def check_replays(e, progs: dict, label: str) -> int:
    """Every graph of `e` replayed on a real program of the session (its
    first `voices` rows) against the eager render_block_sharded /
    render_horizon_sharded of the same program on the same bank and
    strips, and against the graph's torch replay (`CUDAGraph.replay()`
    and a clone of the flat outputs) of the same program: every output
    field torch.equal. On one card every graph replays through the native
    call (the capture left the CUDA generator as it was). Returns the
    graphs checked."""
    from libzl_tpu_torch.engine.graphs import flatten

    g = e._graphs
    keys = g.keys()
    for key in keys:
        prog = np.ascontiguousarray(progs[key.kind][:key.voices])
        sound = e._sound_data_for_backend()
        fn = e._render_fn(key.kind, key.fetch, sound,
                          e._packed_strips_for_backend(), prog.shape[1])
        got, captured = g.render(key, fn, prog, sound)
        want = fn(prog)
        check(not captured, f"{label}: {key} was not captured by warmup")
        for a, b in zip(flatten(got), flatten(want)):
            err = float((a - b).abs().max())
            check(torch.equal(a, b), f"{label}: replay of {key} differs "
                  f"from the eager render by {err:.3e}")
        entry = g._entries[key]
        if len(g.plan) == 1:
            check(entry.native is not None, f"{label}: {key} replays "
                  f"through torch: its capture moved the CUDA generator")
        with entry.lock, torch.cuda.device(g.device):
            entry.stage(prog)
            entry.graph.replay()
            torch_flat = entry.flat.clone()
            for seg in entry.segments:
                seg.done.record()
        got_flat = torch.cat([t.reshape(-1) for t in flatten(got)])
        check(torch.equal(got_flat, torch_flat), f"{label}: the native "
              f"replay of {key} differs from replay() + clone() by "
              f"{float((got_flat - torch_flat).abs().max()):.3e}")
    check(len(keys) > 0, f"{label}: no graph captured")
    return len(keys)


def check_native_counts(e, label: str) -> dict:
    """A one-card engine's replays all went through the native call;
    returns the output slots' counters."""
    stats = e.stats()
    if stats["graph_segments"] == 1:
        check(stats["native_replays"] == stats["graph_replays"],
              f"{label}: {stats['native_replays']} native replays of "
              f"{stats['graph_replays']}")
    return {k: stats[k] for k in ("graph_replays", "native_replays",
                                  "out_slots", "out_slot_fallbacks")}


def graph_session(device) -> dict:
    """The default session at B=128 through two cuda engines in lockstep,
    render_graphs "auto" and "off", GRAPH_SESSION_BLOCKS blocks with a clip
    load (a new bank version, played), a strips change and a note-off:
    every block's every output field torch.equal; the kernels' launches
    equal the two engines' windows blocks and renders, every render of the
    graph engine a replay or a capture."""
    from libzl_tpu_torch.engine.graphs import flatten
    from libzl_tpu_torch.io.wav import AudioData
    from libzl_tpu_torch.models.clip import ClipAudioSource

    engines = [graph_engine(device, LIVE_BLOCK, render_graphs=m)
               for m in ("auto", "off")]
    for e in engines:
        e.warmup()
    torch.cuda.synchronize()
    reset_counts(engines)
    reset_launches()
    t = np.arange(SAMPLE_RATE) / SAMPLE_RATE
    wave = (0.3 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    events = 0
    for i in range(GRAPH_SESSION_BLOCKS):
        for e in engines:
            if i == 100:
                clip = ClipAudioSource(e, audio=AudioData(wave[:, None],
                                                          SAMPLE_RATE))
                clip.play(loop=True, midi_channel=3)
            if i == 200:
                e.set_strip(4, dry=0.55, pan=0.25)
            if i == 300:
                note_off(e, 7)
        got, want = (e.process_block().outputs for e in engines)
        for a, b in zip(flatten(got), flatten(want)):
            check(torch.equal(a, b), f"graph session block {i}: auto "
                  f"differs from off by {float((a - b).abs().max()):.3e}")
        events += i in (100, 200, 300)
    for e in engines:
        e.drain_speculation()
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches(launches, sum(e.fetch_dispatches["windows"]
                                 for e in engines), engines, "graph session")
    check(sum(e.fetch_dispatches["gather"] for e in engines) == 0,
          "graph session: a block fell back to the gather fetch")
    for e in engines:
        check(e.stats()["spec_failures"] == 0, f"graph session: speculative "
              f"build failed: {e.stats()['spec_last_failure']}")
    stats = engines[0].stats()
    native = check_native_counts(engines[0], "graph session")
    return dict(blocks=GRAPH_SESSION_BLOCKS, launches=launches,
                renders=dict(engines[0].render_dispatches),
                native=native, replays=stats["graph_replays"],
                late_captures=stats["late_captures"],
                recaptures=stats["graph_recaptures"],
                stale=stats["graph_stale_renders"],
                adoptions=stats["slo_by_kind"].get("adopt", [0, 0])[1])


def mode_timing(device, mode: str) -> dict:
    """One path's end-to-end numbers: the per-block engine's superblock
    realtime factor and process_block p50 (B=1024, 3 x 40 chained) and live
    p50 / chained mean (B=128, 300 blocks); the default engine at B=128
    (320 chained blocks: process_block p50 and mean, the horizon build and
    adoption wait spans, SLO misses), paced (384 blocks, one a period: the
    lag) and its warmup; the default engine's realtime factor at B=1024
    (120 chained blocks) and its warmup;
    the ABI pump's share of its periods (PUMP_SECONDS)."""
    out = {}
    e = graph_engine(device, SUPER_BLOCK, render_graphs=mode, **PER_BLOCK)
    e.warmup()
    for _ in range(10):
        e.process_block()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(40):
            o = e.process_block()
        o.outputs.master.cpu()
        rounds.append(40 * SUPER_BLOCK / SAMPLE_RATE
                      / (time.perf_counter() - t0))
    out["rt_superblock"] = float(np.median(rounds))
    prof = e.profiler.summary()
    out["super_ms_p50"] = prof["process_block"]["p50_ms"]
    out["super_dispatch_ms_p50"] = prof["dispatch"]["p50_ms"]
    del e

    e = graph_engine(device, LIVE_BLOCK, render_graphs=mode, **PER_BLOCK)
    e.warmup()
    for _ in range(20):
        e.process_block()
    torch.cuda.synchronize()
    ms, t0 = [], time.perf_counter()
    for _ in range(300):
        t1 = time.perf_counter()
        o = e.process_block()
        ms.append((time.perf_counter() - t1) * 1e3)
    o.outputs.master.cpu()
    out["live_ms_p50"] = float(np.median(ms))
    out["live_ms_chained_mean"] = (time.perf_counter() - t0) * 1e3 / 300
    out["live_dispatch_ms_p50"] = e.profiler.summary()["dispatch"]["p50_ms"]
    del e

    e = graph_engine(device, LIVE_BLOCK, render_graphs=mode)
    out.update({f"default_128_{k}": v
                for k, v in measured_warmup(e).items()})
    for _ in range(3 + 4 * e._lookahead):
        e.process_block()
    torch.cuda.synchronize()
    ms, t0 = [], time.perf_counter()
    for _ in range(320):
        t1 = time.perf_counter()
        o = e.process_block()
        ms.append((time.perf_counter() - t1) * 1e3)
    o.outputs.master.cpu()
    out["default_128_ms_p50"] = float(np.median(ms))
    out["default_128_ms_mean"] = float(np.mean(ms))
    out["default_128_rt"] = 320 * LIVE_BLOCK / SAMPLE_RATE / (
        time.perf_counter() - t0)
    out["default_128_spans"] = _spans(e)
    out["default_128_slo_by_kind"] = e.stats()["slo_by_kind"]
    from libzl_tpu_torch.utils.profiling import SloCounter

    period = LIVE_BLOCK / SAMPLE_RATE
    e.slo = SloCounter(budget_seconds=period)
    t0 = time.perf_counter()
    for i in range(384):
        wait = t0 + i * period - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        o = e.process_block()
    o.outputs.master.cpu()
    out["paced_128_lag_ms"] = (time.perf_counter() - t0 - 384 * period) * 1e3
    out["paced_128_slo_by_kind"] = e.stats()["slo_by_kind"]
    check(e.stats()["spec_failures"] == 0,
          f"{mode}: speculative build failed")
    e.drain_speculation()
    del e

    e = graph_engine(device, SUPER_BLOCK, render_graphs=mode)
    out.update({f"default_1024_{k}": v
                for k, v in measured_warmup(e).items()})
    for _ in range(3 + 4 * e._lookahead):
        e.process_block()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(120):
        o = e.process_block()
    o.outputs.master.cpu()
    out["default_1024_rt"] = 120 * SUPER_BLOCK / SAMPLE_RATE / (
        time.perf_counter() - t0)
    e.drain_speculation()
    del e

    with tempfile.TemporaryDirectory() as tmp:
        r = bench.measure_pump(device, bench.write_session_wavs(tmp),
                               PUMP_SECONDS, render_graphs=mode)
    check(r["error"] is None, f"{mode} pump error: {r['error']!r}")
    out["pump_share"] = r["share"]
    out["pump_graphs"] = r["stats"]["graphs"]
    out["pump_late_captures"] = r["stats"]["late_captures"]
    out["pump_recaptures"] = r["stats"]["graph_recaptures"]
    return out


def phase_graphs(device, card: str) -> dict:
    """Render graphs (engine/graphs.py): every graph of a default engine
    (B=128 and B=1024; f32 and int16 banks) replayed on the session's real
    programs, bit-equal to the eager render; a GRAPH_SESSION_BLOCKS-block
    session with graphs bit-equal to the same session eager; then each
    path's end-to-end numbers (mode_timing), in turns."""
    res = {}
    for B, bank, name, opts in ((B, bank, name, opts)
                                for B in (LIVE_BLOCK, SUPER_BLOCK)
                                for bank in ("float32", "int16")
                                for name, opts in horizon_runs(B)):
        t0 = time.perf_counter()
        e = graph_engine(device, B, bank_dtype=bank, **opts)
        warm = measured_warmup(e)
        progs = session_programs(e, 3 + 2 * e._lookahead + 4)
        kinds = {"block", "horizon"} if e._lookahead else {"block"}
        check(set(progs) == kinds,
              f"B={B} {name}: the session dispatched {sorted(progs)}")
        n = check_replays(e, progs, f"B={B} {bank} bank {name}")
        label = f"{B}_{bank}_{name}"
        res[f"replays_checked_{label}"] = n
        counts = check_native_counts(e, f"B={B} {bank} bank {name}")
        res[f"native_{label}"] = counts
        res[f"warmup_{label}"] = warm
        keys = sorted((k.kind, k.voices, k.fetch)
                      for k in e._graphs.keys())
        print(f"[{card}] graphs B={B} {bank} bank, {name} engine "
              f"H={e._lookahead}: {n} graphs (keys "
              f"{keys}), "
              f"each replay bit-equal to the eager render and to "
              f"replay() + clone() (max abs error 0); native replays "
              f"{counts['native_replays']} of {counts['graph_replays']}, "
              f"out_slots {counts['out_slots']}, out_slot_fallbacks "
              f"{counts['out_slot_fallbacks']}; warmup "
              f"{warm['warmup_s']:.3f} s, capture "
              f"{warm['capture_s']:.3f} s, graphs hold "
              f"{warm['graph_bytes'] / 2**20:.1f} MiB, memory_reserved "
              f"+{warm['reserved_growth'] / 2**20:.1f} MiB "
              f"({time.perf_counter() - t0:.1f} s)")
        del e
    t0 = time.perf_counter()
    sess = graph_session(device)
    res["session"] = sess
    print(f"[{card}] graphs session B=128: {sess['blocks']} blocks with a "
          f"clip load, a strips change and a note-off, render_graphs auto "
          f"bit-equal to off every block; graph engine renders "
          f"{json.dumps(sess['renders'])} = {sess['replays']} replays + "
          f"{sess['late_captures']} late captures + {sess['stale']} stale "
          f"({sess['recaptures']} recaptures, {sess['adoptions']} "
          f"adoptions; native {json.dumps(sess['native'])}); kernel "
          f"launches {json.dumps(sess['launches'])} "
          f"({time.perf_counter() - t0:.1f} s)")
    runs = {m: [] for m in GRAPH_MODES}
    for mode in GRAPH_MODES:
        t0 = time.perf_counter()
        runs[mode].append(mode_timing(device, mode))
        print(f"graphs timing {mode}: {time.perf_counter() - t0:.1f} s")
    for mode, rs in runs.items():
        res[mode] = rs
        for i, r in enumerate(rs):
            print(f"[{card}] render_graphs={mode} (run {i + 1}): superblock "
                  f"realtime {r['rt_superblock']:.3f}x, process_block p50 "
                  f"{r['super_ms_p50']:.4f} ms (B=1024, per-block); live "
                  f"p50 {r['live_ms_p50']:.4f} ms, chained mean "
                  f"{r['live_ms_chained_mean']:.4f} ms, dispatch p50 "
                  f"{r['live_dispatch_ms_p50']:.4f} ms (B=128, per-block); "
                  f"default B=128 p50 {r['default_128_ms_p50']:.4f} mean "
                  f"{r['default_128_ms_mean']:.4f} ms, realtime "
                  f"{r['default_128_rt']:.3f}x, spans "
                  f"{json.dumps(r['default_128_spans'])}, slo_by_kind "
                  f"{json.dumps(r['default_128_slo_by_kind'])}; paced lag "
                  f"{r['paced_128_lag_ms']:.1f} ms, slo_by_kind "
                  f"{json.dumps(r['paced_128_slo_by_kind'])}; default "
                  f"B=1024 realtime {r['default_1024_rt']:.3f}x; pump share "
                  f"{r['pump_share']:.3f} ({r['pump_graphs']} graphs, "
                  f"{r['pump_late_captures']} late captures, "
                  f"{r['pump_recaptures']} recaptures); warmup B=128 "
                  f"{r['default_128_warmup_s']:.3f} s "
                  f"({r['default_128_graphs']} graphs, capture {r['default_128_capture_s']:.3f} s, "
                  f"{r['default_128_graph_bytes'] / 2**20:.1f} MiB, reserved "
                  f"+{r['default_128_reserved_growth'] / 2**20:.1f} MiB), "
                  f"B=1024 {r['default_1024_warmup_s']:.3f} s "
                  f"({r['default_1024_graphs']} graphs, capture "
                  f"{r['default_1024_capture_s']:.3f} s, "
                  f"{r['default_1024_graph_bytes'] / 2**20:.1f} MiB, reserved "
                  f"+{r['default_1024_reserved_growth'] / 2**20:.1f} MiB)")
    torch.cuda.synchronize()
    return res


# ----------------------------------------------- the C ABI slice (7-11)

BRIDGE_BLOCKS = 384        # per run: half with global recording (drained),
                           # half with a lane port recording (per block)
PUMP_SECONDS = 5.0


class MemorySink:
    """A non-pacing in-memory audio sink: every block written, in order."""

    pacing = False
    name = "memory"

    def __init__(self):
        self.blocks = []

    def write(self, block):
        self.blocks.append(np.array(block))

    def close(self):
        pass


def bridge_run(device: str, drain, wavs: list, tmp: str) -> dict:
    """One run of phase 7 through the port's bridge, in process: the ABI
    session, an in-memory sink, BRIDGE_BLOCKS/2 blocks with global-playback
    recording only (the bounce drain takes them when K > 1), then
    BRIDGE_BLOCKS/2 with a `lane:2` port recording added (per-block
    delivery, every output copied). Returns the sink stream, the port
    recorder's blocks, the engine's windows/gather dispatches and densest
    lane, and the seconds it took."""
    from libzl_tpu_torch.capi import bridge

    tag = f"{device.replace(':', '')}_{drain}"
    t0 = time.perf_counter()
    with _env(LIBZL_TPU_NO_PUMP=1, LIBZL_TPU_BACKEND=device,
              LIBZL_TPU_VOICES=NUM_VOICES, LIBZL_TPU_BLOCK=LIVE_BLOCK,
              LIBZL_TPU_BOUNCE_DRAIN=drain):
        bridge.init_engine()
    try:
        rt = bridge._rt()
        engine = rt.engine
        abi_session(bridge, wavs)
        sink = MemorySink()
        rt.set_sink(sink)
        bridge.levels_set_record_global_playback(True)
        bridge.levels_set_global_playback_filename_prefix(
            f"{tmp}/global_{tag}")
        bridge.levels_start_recording()
        rt.step_blocks(BRIDGE_BLOCKS // 2)
        bridge.levels_stop_recording()
        lane_blocks = []
        recorder = engine.levels._ports_recorder
        push = recorder.push
        recorder.push = lambda block: (lane_blocks.append(np.array(block)),
                                       push(block))
        bridge.levels_add_record_port("lane:2", 0)
        bridge.levels_add_record_port("lane:2", 1)
        bridge.levels_set_should_record_ports(True)
        bridge.levels_set_record_ports_filename_prefix(f"{tmp}/ports_{tag}")
        bridge.levels_start_recording()
        rt.step_blocks(BRIDGE_BLOCKS - BRIDGE_BLOCKS // 2)
        bridge.levels_stop_recording()
        engine.drain_speculation()
        out = dict(stream=np.concatenate(sink.blocks), lane=np.concatenate(
            lane_blocks), dispatches=dict(engine.fetch_dispatches),
            renders=renders([engine]), densest=_densest_lane(engine),
            drain=rt.bounce_drain_blocks, phases=rt.phase_stats(),
            stats=engine.stats())
    finally:
        bridge.shutdown_engine()
    out["seconds"] = time.perf_counter() - t0
    return out


def _close(got, want, atol: float, label: str) -> float:
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{label}: shape {got.shape} vs {want.shape} / finite")
    err = np.abs(got - want)
    bad = err > atol + MIX_RTOL * np.abs(want)
    check(not bad.any(), f"{label}: max err {err.max():.3e} (atol "
          f"{atol:.1e}, rtol {MIX_RTOL:g}) at {int(bad.sum())} samples")
    return float(err.max())


def phase_bridge(device, wavs: list, tmp: str) -> dict:
    reset_launches()
    runs = {k: bridge_run(device, k, wavs, tmp) for k in ("auto", 1)}
    torch.cuda.synchronize()
    launches = read_launches()
    ref = bridge_run("cpu", 1, wavs, tmp)
    drained, plain = runs["auto"], runs[1]
    check(drained["drain"] == CARD_DRAIN and plain["drain"] == 1,
          f"bounce drain resolved to {drained['drain']}/{plain['drain']}")
    frames = BRIDGE_BLOCKS * LIVE_BLOCK
    for r in (drained, plain, ref):
        check(r["stream"].shape == (frames, 2), f"sink got "
              f"{r['stream'].shape[0]} frames, expected {frames}")
        check(r["lane"].shape == (frames // 2, 2), "lane recording frames")
    check(np.array_equal(drained["stream"], plain["stream"]),
          f"drain-{CARD_DRAIN} sink stream differs from drain-1")
    atol = MIX_ATOL_PER_VOICE * max(ref["densest"], plain["densest"], 1)
    errs = [_close(r["stream"], ref["stream"], atol, f"bridge {k} vs cpu")
            for k, r in runs.items()]
    lane_err = _close(plain["lane"], ref["lane"], atol, "lane recording")
    peak = float(np.abs(plain["lane"]).max())
    check(peak > 0.05, f"lane recording silent (peak {peak})")
    check(float(np.abs(plain["stream"]).max()) > 0.05, "silent sink stream")
    windows = sum(r["dispatches"]["windows"] for r in runs.values())
    gather = sum(r["dispatches"]["gather"] for r in runs.values())
    mixdowns = sum(r["renders"] for r in runs.values())
    for k, r in runs.items():
        check(r["stats"]["spec_failures"] == 0,
              f"drain {k}: speculative build failed")
        print(f"bridge {device} drain {r['drain']}: {BRIDGE_BLOCKS} blocks "
              f"in {r['seconds']:.1f} s (incl. init + 64 clip loads); "
              f"phases {json.dumps(r['phases'])}")
    print(f"bridge: drain-{CARD_DRAIN} == drain-1 (bit-equal); vs cpu "
          f"(densest lane "
          f"{ref['densest']} voices, atol {atol:.1e}) max err "
          f"{max(errs):.3e}; lane:2 recording peak {peak:.3f} max err "
          f"{lane_err:.3e}; kernel launches {json.dumps(launches)}, "
          f"rendered blocks windows {windows} gather {gather}, renders "
          f"{mixdowns}; cpu run {ref['seconds']:.1f} s")
    check(gather == 0, "a block fell back to the gather fetch")
    for name in ("voice_prep", "fetch_interp", "voice_post"):
        check(launches[name] == windows, f"{name} kernel launched "
              f"{launches[name]} times for {windows} rendered blocks")
    for name in ("lane_mixdown", "finish_block"):   # one shard a render
        check(launches[name] == mixdowns, f"{name} kernel launched "
              f"{launches[name]} times for {mixdowns} renders")
    torch.cuda.synchronize()
    return launches


def reset_counts_locked(rt) -> None:
    """With the pump held at the runtime lock and the engine's speculation
    drained (no render in flight on any thread), zero the kernels' launch
    counts and the engine's dispatch counts: the warmup's renders, which
    the engine does not count, stay out of both."""
    def reset():
        rt.engine.drain_speculation()
        torch.cuda.synchronize()
        reset_counts([rt.engine])
        reset_launches()

    rt.run_locked(reset)


def pump_launches(engine, label: str) -> dict:
    """After the pump stopped and the speculation drained: the kernels'
    launches, held to the engine's dispatches."""
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches(launches, engine.fetch_dispatches["windows"], [engine],
                   label)
    check(all(n > 0 for n in launches.values()),
          f"{label}: a kernel was never launched: {launches}")
    return launches


@contextlib.contextmanager
def traced_pumps():
    """A BlockTracer on the engine of each runtime whose pump starts inside
    the block, put on before the pump's warmup and first block
    (EngineRuntime.start_pump wrapped); yields the tracers."""
    from libzl_tpu_torch.capi import bridge as bridge_mod

    cls = bridge_mod.EngineRuntime
    start = cls.start_pump
    tracers = []

    def start_pump(rt):
        if rt._pump is None:
            tracers.append(BlockTracer(rt.engine))
        return start(rt)

    cls.start_pump = start_pump
    try:
        yield tracers
    finally:
        cls.start_pump = start
        for t in tracers:
            t.close()


def named_pump(device, wavs: list, card: str, label: str, **kw) -> dict:
    """bench.measure_pump with a BlockTracer on the engine from before the
    pump starts (traced_pumps): each deadline miss printed with its cause,
    the count by cause returned as "causes"."""
    with traced_pumps() as tracers:
        r = bench.measure_pump(device, wavs, PUMP_SECONDS, **kw)
    r["causes"] = print_misses(card, label, tracers[0].misses)
    missed = r["stats"]["slo_missed"]
    check(len(tracers[0].misses) == missed, f"{label}: named "
          f"{len(tracers[0].misses)} of {missed} misses")
    return r


def phase_pump(device, wavs: list, card: str) -> dict:
    """The wall-clock pump on the card with a null sink and per-block
    delivery (bounce drain 1: what a pacing sink gets), the session loaded
    while it runs; PUMP_SECONDS of it measured (bench.measure_pump), each
    deadline miss named (named_pump)."""
    r = named_pump(device, wavs, card, "pump", before=reset_counts_locked,
                   after=lambda engine: pump_launches(engine, "pump"))
    launches, stats, waits = r["after"], r["stats"], r["copy_wait"]
    print(f"[{card}] pump (1024 voices, B=128, null sink, per-block "
          f"delivery): {r['blocks']} blocks rendered in {r['wall']:.2f} s of "
          f"wall time = {r['periods']:.0f} block periods ({r['share']:.3f}x "
          f"realtime); kernel launches {json.dumps(launches)}")
    nan = float("nan")
    print(f"[{card}] pump copy wait p50 {waits.get('p50_ms', nan):.4f} ms, "
          f"max {waits.get('max_ms', nan):.4f} ms over "
          f"{waits.get('count', 0)} blocks")
    print(f"[{card}] pump phase_stats {json.dumps(r['phase_stats'])}")
    # .get: a copy of this script run on a parent checkout, whose engine
    # has neither the counters nor the span
    ps = r["phase_stats"]
    print(f"[{card}] pump played notes: " + ", ".join(
        f"{k} {stats.get(k)}" for k in ("note_ons", "note_offs",
                                        "starts_dropped", "bucket_changes"))
        + f"; span notes {ps.get('notes_n', 0)} blocks, "
        f"{ps.get('notes_ms', 0.0)} ms")
    print(f"[{card}] pump slo_by_kind {json.dumps(stats['slo_by_kind'])}; "
          f"dsp_load {stats['dsp_load']}")
    check(r["error"] is None, f"pump error: {r['error']!r}")
    check(stats["spec_failures"] == 0,
          f"speculative build failed: {stats['spec_last_failure']}")
    return launches


def phase_shim() -> None:
    """The port's libzl.so driven by the ctypes client in a subprocess on
    the card at the ABI defaults (256 voices, B=128)."""
    from libzl_tpu_torch import _build

    try:
        _build.python_include()
    except FileNotFoundError as e:
        print(f"shim: NOT RUN ({e})")
        return
    t0 = time.perf_counter()
    so = _build.build_shim()
    built = time.perf_counter() - t0
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIBZL_TPU_")}
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "libzl_tpu_torch.capi.abi_client", str(so)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    ran = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    check(proc.returncode == 0, f"abi_client exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    check(bool(out) and out[-1].startswith("CAPI-OK device=cuda"),
          f"abi_client printed {out[-1:] or proc.stdout!r}")
    print(f"shim: {so.name} built in {built:.1f} s; {out[-1]} "
          f"({ran:.1f} s, a subprocess)")


def phase_thumbnails(device, card: str) -> None:
    from libzl_tpu_torch.ops.thumbnail import thumbnail_batch

    waves, _ = session_plan(SAMPLE_RATE)
    T = min(w.shape[0] for w in waves)
    batch = torch.from_numpy(np.stack([w[:T] for w in waves]))
    want = thumbnail_batch(batch, 512)
    on_card = batch.to(device)
    got = thumbnail_batch(on_card, 512)
    for g, w in zip(got, want):
        check(torch.equal(g.cpu(), w), "card thumbnails differ from the CPU")
    ms = float(np.median(_events_ms(lambda: thumbnail_batch(on_card, 512),
                                    20, True)))
    t0 = time.perf_counter()
    thumbnail_batch(batch, 512)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    print(f"[{card}] thumbnails: {len(waves)} clips x {T} frames -> 512 "
          f"buckets, min/max bit-equal to the CPU; card {ms:.4f} ms (p50 "
          f"of 20, CUDA events), host CPU {cpu_ms:.2f} ms")
    torch.cuda.synchronize()


def phase_cli(device, wavs: list, tmp: str) -> None:
    from libzl_tpu_torch.io.wav import read_wav

    out = f"{tmp}/cli_render.wav"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "libzl_tpu_torch.cli", "render", wavs[0], out,
         "--device", device, "--seconds", "2", "--loop"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cli render exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    a = read_wav(out)
    peak = float(np.abs(a.samples).max())
    print(f"cli: {proc.stdout.strip()} ({time.perf_counter() - t0:.1f} s, "
          f"a subprocess); WAV {a.num_frames} frames, peak {peak:.3f}")
    check(a.num_frames >= 2 * SAMPLE_RATE - LIVE_BLOCK, "short render")
    check(peak > 0.05, f"cli render silent (peak {peak})")


# ------------------------------------------- the last modules (12-13)

STRETCH_FACTORS = (0.5, 1.37, 2.0)
STRETCH_RTOL_PEAK = 1e-3       # tests/test_torch_stretch.py


def stretch_clip() -> np.ndarray:
    """2 s of stereo: three partials a channel and a little noise (seed
    5)."""
    rng = np.random.default_rng(5)
    t = np.arange(2 * SAMPLE_RATE) / SAMPLE_RATE
    cols = []
    for _ in range(2):
        f = rng.uniform(80, 2000, 3)[:, None]
        ph = rng.uniform(0, 2 * np.pi, 3)[:, None]
        cols.append((0.2 * np.sin(2 * np.pi * f * t + ph)).sum(0)
                    + 0.02 * rng.standard_normal(t.size))
    return np.stack(cols, axis=1).astype(np.float32)


def _host_ms(fn, n: int = 5) -> float:
    fn()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def phase_stretch(device, card: str) -> dict:
    from libzl_tpu_torch.ops import resample, stretch_native
    from libzl_tpu_torch.ops.stretch_torch import time_stretch_torch

    x = stretch_clip()
    res = {}
    for f in STRETCH_FACTORS:
        a = time_stretch_torch(x, f, device=device)
        b = time_stretch_torch(x, f, device=device)
        want = time_stretch_torch(x, f, device="cpu")
        check(a.shape == want.shape == (int(round(x.shape[0] * f)), 2)
              and np.isfinite(a).all(), f"stretch {f}: shape/finite")
        check(np.array_equal(a, b), f"stretch {f}: card runs differ")
        peak = float(np.abs(want).max())
        err = float(np.abs(a - want).max())
        check(err <= STRETCH_RTOL_PEAK * peak,
              f"stretch {f}: card vs cpu {err:.3e} (peak {peak:.3f})")
        ms = {"torch_cuda": _host_ms(
            lambda: time_stretch_torch(x, f, device=device))}
        ms["torch_cpu"] = _host_ms(
            lambda: time_stretch_torch(x, f, device="cpu"), 2)
        ms["numpy_vocoder"] = _host_ms(lambda: resample.time_stretch(x, f), 2)
        if stretch_native.available():
            ms["wsola"] = _host_ms(
                lambda: stretch_native.time_stretch_wsola(x, f, SAMPLE_RATE))
        res[f] = dict(err=err, peak=peak, ms=ms)
        print(f"[{card}] stretch 2 s stereo x{f}: card vs cpu max err "
              f"{err:.3e} (peak {peak:.3f}, limit {STRETCH_RTOL_PEAK:g} x "
              f"peak), card runs bit-equal; ms (p50, host clock, numpy in "
              f"and out): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))

    # a clip's deferred re-render on its worker thread, through the card
    from libzl_tpu_torch.engine.commands import ClipCommand
    from libzl_tpu_torch.engine.engine import AudioEngine
    from libzl_tpu_torch.io.wav import AudioData
    from libzl_tpu_torch.models.clip import ClipAudioSource

    with _env(LIBZL_TPU_STRETCH="torch", LIBZL_TPU_BACKEND=device):
        eng = AudioEngine(device, sample_rate=SAMPLE_RATE, num_voices=8,
                          lookahead=0)
        clip = ClipAudioSource(eng, audio=AudioData(x, SAMPLE_RATE))
        eng.start_transport(bpm=120)
        changed = []
        clip.playback_changed_callback = lambda: changed.append(True)
        cmd = ClipCommand.channel(clip.id, 0)
        cmd.midi_note = 60
        cmd.change_speed = True
        cmd.speed_ratio = 0.5
        eng.schedule_clip_command(cmd, 0)
        t0 = time.perf_counter()
        while not changed and time.perf_counter() - t0 < 60:
            eng.process_block()
            time.sleep(0.005)
        waited = time.perf_counter() - t0
        check(bool(changed), "the deferred torch re-render never landed")
        got = clip.playback_audio.samples
        want = time_stretch_torch(x, 2.0, device=device)
        check(np.array_equal(got, want),
              "deferred re-render differs from the card vocoder")
        clip.destroy()
    print(f"[{card}] stretch: deferred re-render (speed 0.5) through a cuda "
          f"engine with LIBZL_TPU_STRETCH=torch landed after {waited:.3f} s, "
          f"{got.shape[0]} frames, bit-equal to the card vocoder")
    torch.cuda.synchronize()
    return res


MESH_SHARDS = (2, 4)
# (B, blocks): B=128 covers a horizon build and an adoption at H=16
MESH_RUNS = ((SUPER_BLOCK, 12), (LIVE_BLOCK, 40))
# each mesh engine with render graphs (the default) and eagerly
MESH_MODES = ("auto", "off")


def mesh_label(k: int, mode: str) -> str:
    return f"k={k}" + (" eager" if mode == "off" else "")


def mesh_engines(device, B: int, opts: dict, meshes: dict) -> tuple:
    """({label: engine}, {label: warmup record}) with the session built and
    warmed: "k=1" the unsharded engine on `device` (graphs), then for each
    k of `meshes` ({k: mesh}) an engine with render graphs and one with
    render_graphs "off" (mesh_label)."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    engines, warm = {}, {}
    plan = [(1, None, "auto")] + [(k, m, mode) for k, m in meshes.items()
                                  for mode in MESH_MODES]
    for k, mesh, mode in plan:
        dev = device if mesh is None else mesh.devices[0]
        e = AudioEngine(dev, sample_rate=SAMPLE_RATE, block_frames=B,
                        num_voices=NUM_VOICES, mesh=mesh, render_graphs=mode,
                        **opts)
        build_session(e)
        label = mesh_label(k, mode)
        warm[label] = measured_warmup(e)
        engines[label] = e
    return engines, warm


MESH_FIELDS = ("master", "lane_mix", "lane_peaks", "lane_rms", "voice_peaks")


def _check_equal(got, want, label: str, worst: dict) -> None:
    """One block of a mesh engine against the unsharded engine: every field
    of MESH_FIELDS finite, of the same shape and bit-equal (the carried
    in-order mixdown); audible master. Folds the max errors into
    `worst`."""
    for name in MESH_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{label}: {name} shape/finite")
        a = a.to(b.device)
        err = float((a - b).abs().max())
        worst[name] = max(worst.get(name, 0.0), err)
        check(torch.equal(a, b), f"{label}: {name} differs from the "
              f"unsharded engine by {err:.3e}")
    check(float(want.master.abs().max()) > 0, f"{label}: silent master")


def drive_mesh(engines: dict, n: int, label: str) -> dict:
    """Drive every engine `n` blocks in lockstep, each mesh engine held to
    the unsharded one (the first) every block: bit-equal. {label: the
    max error of each field}."""
    worst = {}
    first = next(iter(engines))
    for i in range(n):
        outs = {k: e.process_block().outputs for k, e in engines.items()}
        for k, o in outs.items():
            if k != first:
                _check_equal(o, outs[first], f"{label} {k} block {i}",
                             worst.setdefault(k, {}))
    for e in engines.values():
        e.drain_speculation()
    return worst


def _mesh_launches(engines: dict, label: str) -> dict:
    """The kernels' launches of a drive_mesh run, held to the engines'
    dispatches: the fetch k x each engine's windows blocks, the mixdown k x
    each engine's renders; every render of a graph engine a replay, a late
    capture or a stale render."""
    launches = read_launches()
    check(sum(e.fetch_dispatches["gather"] for e in engines.values()) == 0,
          f"{label}: a block fell back to the gather fetch")
    check_launches(launches, sum(e.mesh.size * e.fetch_dispatches["windows"]
                                 for e in engines.values()),
                   engines.values(), label)
    for k, e in engines.items():
        check(e.stats()["spec_failures"] == 0,
              f"{label} {k}: speculative build failed: "
              f"{e.stats()['spec_last_failure']}")
    return launches


def check_shard_kernels(engine, k: int) -> int:
    """Each shard's voice prep, windows fetch, voice post and lane mixdown
    (from the mix carried from the shard before) of one more block, and the
    render's finish, rendered eagerly, against the plain versions:
    bit-equal. Returns the per-shard voice count."""
    from libzl_tpu_torch.ops import fetch_windows as fw
    from libzl_tpu_torch.ops import finish as fin
    from libzl_tpu_torch.ops import mixdown as md
    from libzl_tpu_torch.ops import voice_render as vr

    with eager_renders(engine):
        calls = bench.capture_calls(engine.process_block)
    torch.cuda.synchronize()
    counts = {name: len(c) for name, c in calls.items()}
    check(counts == dict(fetch=k, mixdown=k, voice_prep=k, voice_post=k,
                         finish=1), f"kernel calls {counts} for {k} shards")
    for prog, B, ratio in calls["voice_prep"]:
        check(all(torch.equal(a, b) for a, b in zip(
            vr.voice_prep(prog, B, ratio), vr.voice_prep_plain(prog, B, ratio))),
              f"shard voice prep at V={prog.active.shape[0]} differs")
    for args in calls["voice_post"]:
        check(all(torch.equal(a, b) for a, b in zip(
            vr.voice_post(*args), vr.voice_post_plain(*args))),
              f"shard voice post at V={args[0].shape[0]} differs")
    for args in calls["finish"]:
        check(all(torch.equal(a, b) for a, b in zip(
            fin.finish(*args), fin.finish_plain(*args))),
              "the mesh's finish differs from plain")
    for args, r_max in calls["fetch"]:
        check(torch.equal(fw.fetch_interp(*args, r_max=r_max),
                          fw.fetch_interp_plain(*args, r_max=r_max)),
              f"shard kernel at V={args[1].shape[0]} differs from plain")
    for contrib, lane, init in calls["mixdown"]:
        check(torch.equal(md.lane_mixdown(contrib, lane, init=init),
                          md.lane_mixdown_plain(contrib, lane, init=init)),
              f"shard mixdown at V={contrib.shape[0]} differs from plain")
    return int(calls["fetch"][0][0][1].shape[0])


def _mesh_report(engines: dict, warm: dict, timing: dict) -> str:
    """One line: each engine's realtime factor, process_block p50, device
    profile (where taken), render path and warmup (capture s, graph
    MiB)."""
    rows = []
    for label, e in engines.items():
        t, w = timing[label], warm[label]
        stats = e.stats()
        rows.append(
            f"{label} realtime {t['rt']:.3f}x, process_block p50 "
            f"{t['ms_p50']:.4f} ms"
            + (f", device {t['device_ms']:.4f} ms and {t['kernels']:.1f} "
               f"kernels a block, mixdown {100 * t['mixdown_share']:.2f}% "
               f"of device" if "device_ms" in t else "")
            + f", {stats['render_graphs']}"
            + (f" ({stats['graphs']} graphs of {stats['graph_segments']} "
               f"segment(s), warmup {w['warmup_s']:.3f} s, capture "
               f"{w['capture_s']:.3f} s, {w['graph_bytes'] / 2**20:.1f} MiB"
               f")" if stats["render_graphs"] == "graphs" else
               f" (warmup {w['warmup_s']:.3f} s)"))
    return "; ".join(rows)


def mesh_modes() -> list:
    """(mode, engine options, B, blocks) of phase 13: the per-block engine,
    then the horizon engine (horizon_runs: the default where "auto"
    resolves to a horizon on the card) at each of MESH_RUNS."""
    modes = [("per-block", dict(lookahead=0), B, n) for B, n in MESH_RUNS]
    for B, n in MESH_RUNS:
        label, opts = horizon_runs(B)[-1]
        modes.append((label, opts, B, n))
    return modes


def phase_mesh(device, card: str) -> tuple:
    from libzl_tpu_torch.parallel.sharding import canonical_device, make_mesh

    first = canonical_device(device)
    meshes = {k: make_mesh(devices=[first] * k) for k in MESH_SHARDS}
    total, timing = {}, {}
    for mode, opts, B, n in mesh_modes():
        t0 = time.perf_counter()
        engines, warm = mesh_engines(first, B, opts, meshes)
        for k, e in engines.items():
            check(e.fetch == "windows", f"{k}: fetch {e.fetch}")
        reset_counts(engines.values())
        torch.cuda.synchronize()
        reset_launches()
        worst = drive_mesh(engines, n, f"mesh {mode} B={B}")
        torch.cuda.synchronize()
        launches = _mesh_launches(engines, f"mesh {mode} B={B}")
        windows = {k: e.fetch_dispatches["windows"]
                   for k, e in engines.items()}
        rendered = {k: sum(e.render_dispatches.values())
                    for k, e in engines.items()}
        total = add_launches(total, launches)
        shard_v = {k: check_shard_kernels(engines[label], k)
                   for k in MESH_SHARDS
                   for label in [mesh_label(k, "off")]
                   if not engines[label]._lookahead}
        runs = {}
        for label, e in engines.items():
            runs[label] = time_mesh(e, 20 if B == SUPER_BLOCK else 96)
            if not e._lookahead:
                runs[label].update(_device_profile(e, 10))
            runs[label].update(
                {f"warmup_{k}": v for k, v in warm[label].items()})
            timing[f"{mode}_{B}_{label}"] = runs[label]
        print(f"mesh {mode} B={B} H={engines['k=1']._lookahead}: {n} "
              f"blocks; "
              + "; ".join(f"{k} max err " + ", ".join(
                  f"{a} {v:.3e}" for a, v in w.items())
                  for k, w in worst.items())
              + f"; windows blocks {windows}, renders {rendered}"
              f", kernel launches {json.dumps(launches)} (= sum of k x "
              f"blocks, k x renders; graph engines: every render a "
              f"replay, late capture or stale render)"
              + (f"; shard voice preps, fetches, voice posts and "
                 f"mixdowns and the finish bit-equal to plain at V="
                 f"{sorted(shard_v.values())}" if shard_v else "")
              + f" ({time.perf_counter() - t0:.1f} s)")
        print(f"[{card}] mesh {mode} B={B}: "
              + _mesh_report(engines, warm, runs)
              + " (chained blocks, one sync at the end; device from "
              "torch.profiler over 10 more)")
        del engines
    if torch.cuda.device_count() >= 2:
        total = add_launches(total, phase_mesh_cards(card))
    else:
        print("mesh across cards: NOT RUN: one card")
    torch.cuda.synchronize()
    return total, {k.replace(" ", "_").replace("=", ""): v
                   for k, v in timing.items()}


def sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_mesh_cards(card: str) -> dict:
    """Phase 13 across every visible card (make_mesh(), two or more): the
    session per-block at B=1024 and with the default options at B=128,
    through the chain of per-card render graphs and eagerly, each block
    bit-equal to the unsharded engine on the first card; launches equal
    to shards x windows blocks and shards x renders, every render of the
    graph engine a replay; each card's fetch and mixdown call bit-equal to
    the plain version on that card; realtime factor, process_block ms and
    warmup per engine. Returns the kernels' launches."""
    from libzl_tpu_torch.parallel.sharding import make_mesh

    cards = make_mesh()
    k = cards.size
    check(k >= 2, f"mesh across cards needs two or more cards, has {k}")
    total = {}
    for mode, opts, B, n in (("per-block", dict(lookahead=0), SUPER_BLOCK, 8),
                             (*horizon_runs(LIVE_BLOCK)[-1], LIVE_BLOCK, 40)):
        t0 = time.perf_counter()
        engines, warm = mesh_engines(cards.devices[0], B, opts, {k: cards})
        reset_counts(engines.values())
        sync_cards()
        reset_launches()
        label = f"mesh across {k} cards {mode} B={B}"
        worst = drive_mesh(engines, n, label)
        sync_cards()
        launches = _mesh_launches(engines, label)
        windows = {kk: e.fetch_dispatches["windows"]
                   for kk, e in engines.items()}
        total = add_launches(total, launches)
        eager = engines[mesh_label(k, "off")]
        shard_v = (check_shard_kernels(eager, k) if not eager._lookahead
                   else None)
        timing = {kk: time_mesh(e, 20 if B == SUPER_BLOCK else 96)
                  for kk, e in engines.items()}
        sync_cards()
        print(f"mesh across {k} cards ({', '.join(map(str, cards.devices))})"
              f" {mode} B={B} H={engines['k=1']._lookahead}: {n} blocks; "
              + "; ".join(f"{kk} max err " + ", ".join(
                  f"{a} {v:.3e}" for a, v in w.items())
                  for kk, w in worst.items())
              + f"; windows blocks {windows}, kernel launches "
              f"{json.dumps(launches)} (= sum of k x blocks, k x renders)"
              + (f"; each card's voice kernels, fetch and mixdown, and the "
                 f"finish, bit-equal to plain at V={shard_v}" if shard_v
                 else "")
              + f" ({time.perf_counter() - t0:.1f} s)")
        print(f"[{card}] mesh across {k} cards {mode} B={B}: "
              + _mesh_report(engines, warm, timing)
              + " (chained blocks, one sync at the end)")
        del engines
    return total


# ------------------------------------------------------- the soak (14)

SOAK_VOICES = 1024
SOAK_RECORDED_SHARE = 0.95   # of the frames rendered while recording
SOAK_SILENT = 0.01           # a recording peaking below this is silent


def soak_wavs(tmp: str) -> list:
    """tools/tpu_soak_r3.py's four clips: two-partial sines at 110, 220.5,
    331 and 441.5 Hz, 0.5 to 1.4 s long."""
    from libzl_tpu_torch.io.wav import write_wav

    paths = []
    for i, freq in enumerate((110.0, 220.5, 331.0, 441.5)):
        t = np.arange(int(SAMPLE_RATE * (0.5 + 0.3 * i))) / SAMPLE_RATE
        w = (0.35 * np.sin(2 * np.pi * freq * t)
             + 0.1 * np.sin(2 * np.pi * 2 * freq * t)).astype(np.float32)
        paths.append(f"{tmp}/soak_in{i}.wav")
        write_wav(paths[-1], w, SAMPLE_RATE)
    return paths


def phase_soak(device, card: str, tmp: str, seconds: float,
               event_seconds: float) -> dict:
    """tools/tpu_soak_r3.py on the port: the bridge's wall-clock pump with a
    file sink, global playback recorded, a random clip retriggered every
    `event_seconds` for `seconds`. Returns the kernels' launches."""
    from libzl_tpu_torch.capi import bridge
    from libzl_tpu_torch.io.wav import read_wav

    rng = np.random.default_rng(7)
    wavs = soak_wavs(tmp)
    rec_path = f"{tmp}/soak_rec.wav"
    t0 = time.perf_counter()
    with _env(LIBZL_TPU_NO_PUMP=None, LIBZL_TPU_BACKEND=device,
              LIBZL_TPU_VOICES=SOAK_VOICES, LIBZL_TPU_BLOCK=LIVE_BLOCK,
              LIBZL_TPU_WARMUP=1, LIBZL_TPU_PIPELINE=2,
              LIBZL_TPU_BOUNCE_DRAIN=None,
              LIBZL_TPU_SINK=f"file:{tmp}/soak_sink.wav"):
        bridge.init_engine()
    boot = time.perf_counter() - t0
    try:
        rt = bridge._rt()
        engine = rt.engine
        check(rt._pump is not None, "the pump did not start")
        reset_counts_locked(rt)
        ids = [bridge.clip_new(p) for p in wavs]
        bridge.levels_set_record_global_playback(True)
        bridge.levels_set_global_playback_filename_prefix(rec_path)
        bridge.levels_start_recording()
        rec_b0 = engine.total_blocks
        bridge.timer_start(124)
        for cid in ids:
            bridge.clip_play(cid, True)
        b0, w0 = engine.total_blocks, time.monotonic()
        deadline = w0 + seconds
        retriggers = 0
        while time.monotonic() < deadline:
            time.sleep(min(event_seconds, max(deadline - time.monotonic(),
                                              0.0)))
            if time.monotonic() < deadline:
                bridge.clip_play(ids[int(rng.integers(0, len(ids)))], True)
                retriggers += 1
        wall = time.monotonic() - w0
        blocks = engine.total_blocks - b0
        for cid in ids:
            bridge.clip_stop(cid)
        time.sleep(0.5)
        bridge.levels_stop_recording()
        rec_blocks = engine.total_blocks - rec_b0
        bridge.timer_stop()
        rt.stop_pump()
        engine.drain_speculation()
        stats = engine.stats()
        phases = rt.phase_stats()
        error = rt.pump_error
        launches = pump_launches(engine, "soak")
    finally:
        bridge.shutdown_engine()
    rec = read_wav(rec_path).samples
    expected = wall * SAMPLE_RATE / LIVE_BLOCK
    finite = bool(np.isfinite(rec).all())
    peak = float(np.abs(rec).max()) if rec.size else 0.0
    out = dict(
        seconds=seconds, event_seconds=event_seconds, retriggers=retriggers,
        voices=SOAK_VOICES, boot_seconds=boot, blocks=blocks,
        blocks_expected=expected,
        sustained_realtime=bool(blocks >= 0.99 * expected),
        slo_missed=stats["slo_missed"], slo_total=stats["slo_total"],
        slo_by_kind=stats["slo_by_kind"], dsp_load=stats["dsp_load"],
        watchdog_scheduled=stats["watchdog_scheduled"],
        watchdog_delivered=stats["watchdog_delivered"],
        watchdog_mismatches=stats["watchdog_mismatches"],
        watchdog_lost=stats["watchdog_lost"],
        spec_failures=stats["spec_failures"],
        pump_error=repr(error) if error else None,
        recorded_blocks=rec_blocks,
        recorded_seconds=rec.shape[0] / SAMPLE_RATE, recorded_peak=peak,
        recorded_finite=finite, launches=launches, phase_stats=phases)
    print(f"[{card}] soak {json.dumps(out)}")
    check(error is None, f"soak: pump error {error!r}")
    check(stats["spec_failures"] == 0,
          f"soak: speculative build failed: {stats['spec_last_failure']}")
    check(stats["watchdog_mismatches"] == 0 and stats["watchdog_lost"] == 0,
          f"soak: watchdog mismatches {stats['watchdog_mismatches']}, lost "
          f"{stats['watchdog_lost']}")
    check(finite, "soak: non-finite recorded sample")
    check(peak > SOAK_SILENT, f"soak: silent recording (peak {peak})")
    want = SOAK_RECORDED_SHARE * rec_blocks * LIVE_BLOCK
    check(rec.shape[0] >= want, f"soak: recorded {rec.shape[0]} frames, "
          f"fewer than {want:.0f} ({SOAK_RECORDED_SHARE} x {rec_blocks} "
          f"blocks)")
    return launches


def phase_examples(device, tmp: str) -> None:
    """libzl_tpu_torch/examples' live_rig and midi_live_demo on the card for
    1 s each, each in a subprocess."""
    from libzl_tpu_torch.io.wav import read_wav

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIBZL_TPU_")}
    env["PYTHONPATH"] = str(ROOT)

    def run(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", *args], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"{args[0]} exited {proc.returncode}: "
              f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        return proc.stdout.strip().splitlines(), time.perf_counter() - t0

    out, secs = run("libzl_tpu_torch.examples.live_rig", "--device", device,
                    "--seconds", "1")
    check("live rig OK" in out, f"live_rig printed {out[-3:]}")
    print(f"examples: live_rig on {device}: "
          + "; ".join(out[-4:-1]) + f" -> live rig OK ({secs:.1f} s)")
    wav = f"{tmp}/midi_live_demo.wav"
    out, secs = run("libzl_tpu_torch.examples.midi_live_demo", wav,
                    "--device", device, "--seconds", "1")
    samples = read_wav(wav).samples
    peak = float(np.abs(samples).max())
    print(f"examples: midi_live_demo on {device}: {out[-1]} ({secs:.1f} s); "
          f"WAV {samples.shape[0]} frames, peak {peak:.3f}")
    check(np.isfinite(samples).all() and peak > 0.005,
          f"midi_live_demo WAV peak {peak}")


BENCH_BUDGET_S = 150.0


def phase_bench(card: str) -> tuple:
    """The port's benchmark (python -m libzl_tpu_torch.bench) in process at
    its short sizes and a short budget: every key of its line present, every
    cell finite and positive, no cell failed or skipped, no share of a bound
    over 100, and every kernel launched. Returns (the line, the kernels'
    launches)."""
    run = bench.Run("cuda:0", BENCH_BUDGET_S, reserve_s=5.0)
    reset_launches()
    bench.run_cells(run, bench.QUICK)
    torch.cuda.synchronize()
    launches = read_launches()
    line = run.line(partial=False)
    print(f"[{card}] bench {json.dumps(line)}; kernel launches "
          f"{json.dumps(launches)}")
    check(all(n > 0 for n in launches.values()),
          f"bench: a kernel was never launched: {launches}")
    check(not run.failed and not run.skipped,
          f"bench cells failed {run.failed}, skipped {run.skipped}")
    for key in ("value", "vs_baseline", "rt_superblock", "rt_superblock_best",
                *bench.CELLS):
        check(key in line and np.isfinite(line[key]) and line[key] > 0,
              f"bench {key} = {line.get(key)!r}")
    check(len(line["rt_superblock_rounds"]) == bench.QUICK["throughput"][0],
          f"bench rounds {line['rt_superblock_rounds']}")
    check(line["device"] == card, f"bench device {line['device']!r}")
    for key in ("kernel_pct_of_bound", "pct_of_bound"):
        check(line[key] <= 100.0, f"bench {key} = {line[key]} exceeds 100")
    return line, launches


# ------------------------------- deadline misses, named (phases 8, 17, 18)

# the engine's spans of a block under process_block, on the thread that
# runs it (the program's record, utils/profiling)
TOP_SPANS = ("commands", "host_program", "dispatch", "horizon_build",
             "adopt_wait", "emit")


class BlockTracer:
    """Per-block records of one engine, read from the program's span record
    (libzl_tpu_torch.utils.profiling, recording from here on if it was
    not): a block's spans on its thread (process_block and what it holds,
    summed by name, ms: TOP_SPANS, lookahead, graphs.DISPATCH_SPANS) and
    the collections that ran while it did ([generation, ms, on the block's
    thread]). What the record does not hold is taken from outside: the
    engine's process_block and _note_slo_miss and its render graphs'
    _replay and warm are wrapped for the block's first realtime replays of
    a graph on its thread, the graphs' warm replays on its thread (span
    "warm", inside another span: a rebind's), its late captures and
    recaptures, the deferred clip renders waiting at its start, whether the
    bank was uploaded, and, with `memory`, the caching allocator's
    segment.all.allocated and num_alloc_retries before and after. A missed
    block's record also holds its kind, overrun and cause (miss_cause).
    Keeps every missed block (`misses`) and the first `keep` blocks
    (`blocks`); `collections` holds every collection while installed.
    `close()` takes every wrapper off and stops a recording it started."""

    CAPACITY = 1 << 20

    def __init__(self, engine, keep: int = 0, memory: bool = False):
        import weakref

        from libzl_tpu_torch.utils import profiling

        self.engine = engine
        self.keep = keep
        self.memory = memory
        self.blocks = []
        self.misses = []
        self.collections = []       # every collection while installed
        self.history = {}           # part -> its ms in each block before
        self._cur = None
        self._thread = None
        self._label = None
        self._seen = weakref.WeakKeyDictionary()   # entry -> {thread}
        self._profiling = profiling
        self._started = not profiling.recording()
        if self._started:
            profiling.start_recording(self.CAPACITY)
        self._since = profiling.mark()
        tracer = self
        block = engine.process_block
        note = engine._note_slo_miss

        def process_block():
            rec = tracer._begin()
            try:
                return block()
            finally:
                tracer._end(rec)

        def note_slo_miss(kind, busy, budget_blocks):
            rec = tracer._cur
            if rec is not None and threading.get_ident() == tracer._thread:
                rec["miss"] = dict(kind=kind, budget_blocks=budget_blocks,
                                   overrun_ms=(busy - budget_blocks
                                               * engine.slo.budget) * 1e3)
            return note(kind, busy, budget_blocks)

        engine.process_block = process_block
        engine._note_slo_miss = note_slo_miss
        g = engine._graphs
        if g is not None:
            replay = g._replay

            def traced_replay(entry, prog, warm, profiler=None):
                rec = tracer._cur
                me = threading.get_ident()
                if not warm and rec is not None and me == tracer._thread:
                    threads = tracer._seen.setdefault(entry, set())
                    if me not in threads:
                        threads.add(me)
                        rec["first_replays"] += 1
                return replay(entry, prog, warm, profiler)

            g._replay = traced_replay
            warm = getattr(g, "warm", None)

            def traced_warm(keys=None):
                t0 = time.perf_counter()
                try:
                    return warm(keys)
                finally:
                    rec = tracer._cur
                    if rec is not None and threading.get_ident() == \
                            tracer._thread:
                        rec["spans"]["warm"] = (rec["spans"].get("warm", 0.0)
                                                + (time.perf_counter() - t0)
                                                * 1e3)

            if warm is not None:
                g.warm = traced_warm

    def close(self) -> None:
        for name in ("process_block", "_note_slo_miss"):
            self.engine.__dict__.pop(name, None)
        if self.engine._graphs is not None:
            self.engine._graphs.__dict__.pop("_replay", None)
            self.engine._graphs.__dict__.pop("warm", None)
        if self._started:
            self._profiling.stop_recording()

    def _graph_counts(self) -> tuple:
        g = self.engine._graphs
        return (self.engine.late_captures,
                0 if g is None else g.recaptures)

    def _mem(self) -> tuple:
        s = torch.cuda.memory_stats(self.engine.device)
        return (s.get("segment.all.allocated", 0),
                s.get("num_alloc_retries", 0))

    def _begin(self) -> dict:
        e = self.engine
        if not self._profiling.recording():
            # another tracer's close() stopped the record
            self._profiling.start_recording(self.CAPACITY)
            self._started, self._since = True, None
        rec = dict(block=e.total_blocks + 1, spans={}, gc=[],
                   first_replays=0, pending=len(e._pending_renders),
                   bank=e._bank_version_on_device, miss=None,
                   counts=self._graph_counts(),
                   mem=self._mem() if self.memory else None)
        self._thread = threading.get_ident()
        self._label = self._profiling.thread_label()
        self._cur = rec
        return rec

    def _read(self, rec: dict) -> None:
        """The block's spans and the collections, from the record."""
        profiling = self._profiling
        got = profiling.export(self._since)
        self._since = got["next"]
        if got["dropped"] and self._started:
            # the record is full: start it afresh from the next block
            profiling.start_recording(self.CAPACITY)
            self._since = None
        mine = [s for s in got["spans"] if s["block"] == rec["block"]
                and s["thread"] == self._label and s["name"] != "gc"]
        for s in mine:
            rec["spans"][s["name"]] = (rec["spans"].get(s["name"], 0.0)
                                       + (s["end_ns"] - s["start_ns"]) / 1e6)
        block = [s for s in mine if s["name"] == "process_block"]
        a = block[0]["start_ns"] if block else 0
        b = block[0]["end_ns"] if block else 0
        for s in got["spans"]:
            if s["name"] != "gc":
                continue
            run = [s["generation"], (s["end_ns"] - s["start_ns"]) / 1e6,
                   s["thread"] == self._label]
            self.collections.append(run)
            if s["start_ns"] < b and s["end_ns"] > a:
                rec["gc"].append(run)

    def _end(self, rec: dict) -> None:
        self._cur = None
        e = self.engine
        self._read(rec)
        late, recaptures = self._graph_counts()
        rec["late"] = late - rec["counts"][0]
        rec["recaptures"] = recaptures - rec["counts"][1]
        rec["bank_upload"] = rec.pop("bank") != e._bank_version_on_device
        rec["ms"] = rec["spans"].get("process_block", 0.0)
        if self.memory:
            rec["mem"] = (rec["mem"], self._mem())
        parts = block_parts(rec)
        if rec["miss"] is not None:
            rec["miss"]["cause"] = miss_cause(rec, parts, self.history)
            self.misses.append(rec)
        for k, v in parts.items():
            self.history.setdefault(k, []).append(v)
        if len(self.blocks) < self.keep:
            self.blocks.append(rec)


def block_parts(rec: dict) -> dict:
    """A block's parts in ms: its top-level spans (TOP_SPANS), the time
    outside them, and a dispatch's parts (graphs.DISPATCH_SPANS)."""
    from libzl_tpu_torch.engine.graphs import DISPATCH_SPANS

    spans = rec["spans"]
    parts = {k: spans.get(k, 0.0) for k in TOP_SPANS}
    parts["outside every span"] = max(rec["ms"] - sum(parts.values()), 0.0)
    parts.update((k, spans[k]) for k in DISPATCH_SPANS if k in spans)
    return parts


# a part this many times its median over the blocks before (and at least
# STALL_MIN_BLOCKS of them) did no more work: its thread waited
STALL_RATIO = 10.0
STALL_MIN_BLOCKS = 20
# parts whose work varies from block to block (the commands applied) or
# that wait by design (for the chain's next horizon, for a staging slot's
# last copy on the card)
STALL_EXEMPT = ("commands", "adopt_wait", "dispatch_slot_wait")


def miss_cause(rec: dict, parts: dict, history: dict) -> str:
    """A missed block's cause, from its record (BlockTracer), tried in
    order: a recapture after the bank grew; a late capture; collections on
    the block's thread for at least half the overrun, then on another
    thread (which held the GIL); a graph's first realtime replay on this
    thread whose staging, output slot and replay took half the overrun; then
    the largest of the block's top-level parts (`parts`, block_parts): the
    commands, a dispatch (named by its largest part),
    host_program, horizon_build, adopt_wait, emit, or the time outside
    every span (deferred clip renders swapped in, the bank's upload after
    a clip load, else GIL or scheduler). A part at STALL_RATIO times its
    median over the blocks before (not one of STALL_EXEMPT) is named
    "stalled: GIL or scheduler" after it: its work is the same every
    block. The thread's CPU clock cannot tell instead: on the card's host
    time.thread_time() moves in steps of 10 ms."""
    over = rec["miss"]["overrun_ms"]
    spans = rec["spans"]
    if rec["recaptures"]:
        return "recapture after bank growth"
    if rec["late"]:
        return "late capture"
    for on_block, where in ((True, ""), (False, " on another thread")):
        runs = [(gen, ms) for gen, ms, mine in rec["gc"] if mine == on_block]
        if runs and sum(ms for _, ms in runs) >= over / 2:
            return (f"collection{where} (generation "
                    f"{max(gen for gen, _ in runs)})")
    first = sum(spans.get(k, 0.0) for k in ("dispatch_stage",
                                            "dispatch_out",
                                            "dispatch_replay"))
    if rec["first_replays"] and first >= over / 2:
        return "first replay of a key"
    top = {k: parts[k] for k in (*TOP_SPANS, "outside every span")}
    big = max(top, key=top.get)
    name = big
    if big == "dispatch":
        inner = {k: v for k, v in parts.items() if k.startswith("dispatch_")}
        if inner:
            big = max(inner, key=inner.get)
            name = f"dispatch ({big})"
    elif big == "outside every span":
        if rec["pending"]:
            return "deferred clip render swapped in"
        if rec["bank_upload"]:
            return "bank upload after a clip load"
    past = history.get(big, [])
    if (big not in STALL_EXEMPT and len(past) >= STALL_MIN_BLOCKS
            and parts[big] >= STALL_RATIO * max(np.median(past), 1e-3)):
        return f"{name}, stalled: GIL or scheduler"
    if big == "outside every span":
        return "outside every span (GIL or scheduler)"
    return name


def miss_line(rec: dict) -> str:
    """One missed block: number, kind, ms, overrun, cause, its spans and
    collections."""
    m = rec["miss"]
    spans = ", ".join(f"{k} {v:.3f}" for k, v in rec["spans"].items()
                      if k != "process_block")
    gcs = ", ".join(f"gen{gen} {ms:.3f}{'' if mine else ' (other thread)'}"
                    for gen, ms, mine in rec["gc"])
    return (f"block {rec['block']} {m['kind']} {rec['ms']:.3f} ms, over by "
            f"{m['overrun_ms']:.3f} ms: {m['cause']} [spans {spans or 'none'}"
            f"; gc {gcs or 'none'}; first replays {rec['first_replays']}, "
            f"deferred renders {rec['pending']}]")


def print_misses(card: str, label: str, misses: list) -> dict:
    """Each miss on its line, then the count by cause; returns it."""
    causes = {}
    for rec in misses:
        print(f"[{card}] {label} miss: {miss_line(rec)}")
        c = rec["miss"]["cause"]
        causes[c] = causes.get(c, 0) + 1
    print(f"[{card}] {label}: {len(misses)} misses by cause "
          f"{json.dumps(causes)}")
    return causes


# ------------------------------------------------- dispatch policy (17)

POLICY_ROUNDS = 3
POLICY_H = (0, 2, 4, 8, 16)
# chained blocks a round at each B (about 1.7 s of audio at B <= 256)
POLICY_BLOCKS = {LIVE_BLOCK: 640, 256: 320, SUPER_BLOCK: 120}
POLICY_PACED = 384              # paced blocks a round, at B <= 256
POLICY_PUMP_H = (0, 8, 16)
POLICY_DRAIN_K = (1, 8, 16, 32, 64)
POLICY_DRAIN_BLOCKS = {LIVE_BLOCK: 384, SUPER_BLOCK: 128}
POLICY_K_WITHIN = 0.05          # K: the smallest within 5% of the best


def _rotated(items, r: int) -> list:
    """Round r's order of `items`: rotated by r, so no setting always runs
    first or last."""
    items = list(items)
    r %= len(items)
    return items[r:] + items[:r]


def _med_spread(values) -> tuple:
    """(median, max - min) of a setting's rounds."""
    return float(np.median(values)), float(np.max(values) - np.min(values))


def _misses(kinds: dict) -> int:
    return sum(v[0] for v in kinds.values())


def _add_kinds(total: dict, kinds: dict) -> dict:
    """slo_by_kind summed over runs: [missed, total, worst overrun s]."""
    out = {k: list(v) for k, v in total.items()}
    for k, (missed, n, worst) in kinds.items():
        m = out.setdefault(k, [0, 0, 0.0])
        m[0] += missed
        m[1] += n
        m[2] = max(m[2], worst)
    return out


def policy_engine(device, B: int, H: int):
    """The session on a default engine at lookahead H, warmed; its first
    block after warmup run and its deadline misses kept apart. A
    BlockTracer (`e.tracer`) names every miss from here on: the first
    block's is `e.first_misses`."""
    from libzl_tpu_torch.utils.profiling import SloCounter

    e = graph_engine(device, B, lookahead=H)
    e.warmup()
    torch.cuda.synchronize()
    e.slo = SloCounter(budget_seconds=B / SAMPLE_RATE)
    e.tracer = BlockTracer(e)
    e.process_block().outputs.master.cpu()
    e.first_kinds = e.stats()["slo_by_kind"]
    e.first_misses, e.tracer.misses = e.tracer.misses, []
    e.drain_speculation()
    return e


def warm_replays(e) -> str:
    """The engine's graphs, those warm-replayed and its warm replays."""
    g = e._graphs
    if g is None:
        return "eager"
    entries = list(g._entries.values())
    warmed = sum(1 for x in entries if getattr(x, "warmed", None))
    return (f"{warmed} of {len(entries)} graphs warm-replayed, "
            f"{e.stats().get('graph_warm_replays', 0)} warm replays")


def policy_round(e, paced: bool) -> dict:
    """One round of a lookahead setting: chained blocks (one sync at the
    end) for the realtime factor and process_block p50 / p99 / mean and
    the horizon spans; at B <= 256 then a paced run (one block a period)
    for the lag; deadline misses of both; renders and kernels a block over
    both, the speculation drained at the end (which drops the horizon: the
    next round starts from the per-block path, as after an event)."""
    from libzl_tpu_torch.utils.profiling import BlockProfiler, SloCounter

    B = e.block_frames
    period = B / SAMPLE_RATE
    n = POLICY_BLOCKS[B]
    e.slo = SloCounter(budget_seconds=period)
    e.profiler = BlockProfiler()
    renders0 = sum(e.render_dispatches.values())
    launches0 = read_launches()
    ms = []
    t0 = time.perf_counter()
    for _ in range(n):
        t1 = time.perf_counter()
        out = e.process_block()
        ms.append((time.perf_counter() - t1) * 1e3)
    out.outputs.master.cpu()
    rt = n * B / SAMPLE_RATE / (time.perf_counter() - t0)
    r = dict(rt=rt, p50=float(np.percentile(ms, 50)),
             p99=float(np.percentile(ms, 99)), mean=float(np.mean(ms)),
             kinds=e.stats()["slo_by_kind"], spans=_spans(e), lag=None,
             paced_kinds={})
    if paced:
        e.slo = SloCounter(budget_seconds=period)
        t0 = time.perf_counter()
        for i in range(POLICY_PACED):
            wait = t0 + i * period - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            out = e.process_block()
        out.outputs.master.cpu()
        r["lag"] = (time.perf_counter() - t0 - POLICY_PACED * period) * 1e3
        r["paced_kinds"] = e.stats()["slo_by_kind"]
        n += POLICY_PACED
    e.drain_speculation()
    torch.cuda.synchronize()
    launches = read_launches()
    r["renders"] = (sum(e.render_dispatches.values()) - renders0) / n
    r["kernels"] = sum(launches[k] - launches0[k] for k in launches) / n
    check(e.stats()["spec_failures"] == 0, f"policy B={B} H={e._lookahead}: "
          f"speculative build failed: {e.stats()['spec_last_failure']}")
    return r


def decide_lookahead(rows: dict, B: int) -> tuple:
    """PERF.md's rule for one B over {H: row}: keep the settings with no
    deadline miss in any round (the first block after warmup not counted)
    and a median paced lag within one block period; take the highest
    median realtime; a setting whose median is within the larger of the
    two spreads of that one ties with it, and the smallest H of a tie
    wins. With no setting clean, the fewest misses (then the rule above
    among those). Returns (H, why)."""
    period_ms = B / SAMPLE_RATE * 1e3
    lag_ok = {H: r["lag"] is None or r["lag"] <= period_ms
              for H, r in rows.items()}
    clean = [H for H, r in rows.items() if r["misses"] == 0 and lag_ok[H]]
    why = "no misses, lag within a period"
    if not clean:
        fewest = min(r["misses"] for r in rows.values())
        clean = [H for H, r in rows.items() if r["misses"] == fewest]
        why = f"no setting clean: the fewest misses ({fewest})"
    best = max(clean, key=lambda H: rows[H]["rt"])
    ties = [H for H in clean if rows[best]["rt"] - rows[H]["rt"]
            <= max(rows[best]["rt_spread"], rows[H]["rt_spread"])]
    H = min(ties)
    return H, (f"{why}: {sorted(clean)}; best median realtime H={best}; "
               f"ties within the spread {sorted(ties)}")


def policy_lookahead(device, card: str) -> dict:
    """H in POLICY_H at B = 128, 256 and 1024, POLICY_ROUNDS interleaved
    rounds a setting in rotated order; each setting's medians, spreads and
    misses, and the decision of decide_lookahead for each B."""
    from libzl_tpu_torch.engine import engine as engine_mod

    out = {}
    for B in (LIVE_BLOCK, 256, SUPER_BLOCK):
        t0 = time.perf_counter()
        engines = {H: policy_engine(device, B, H) for H in POLICY_H}
        rounds = {H: [] for H in POLICY_H}
        for r in range(POLICY_ROUNDS):
            for H in _rotated(POLICY_H, r):
                rounds[H].append(policy_round(engines[H], B <= 256))
        rows = {}
        for H, rs in rounds.items():
            kinds = {}
            for x in rs:
                kinds = _add_kinds(_add_kinds(kinds, x["kinds"]),
                                   x["paced_kinds"])
            rt, rt_spread = _med_spread([x["rt"] for x in rs])
            lags = [x["lag"] for x in rs if x["lag"] is not None]
            rows[H] = dict(
                rt=rt, rt_spread=rt_spread, rt_rounds=[x["rt"] for x in rs],
                p50=_med_spread([x["p50"] for x in rs]),
                p99=_med_spread([x["p99"] for x in rs]),
                mean=_med_spread([x["mean"] for x in rs]),
                lag=_med_spread(lags)[0] if lags else None,
                lag_rounds=lags, kinds=kinds, misses=_misses(kinds),
                first=engines[H].first_kinds,
                first_misses=engines[H].first_misses,
                misses_named=engines[H].tracer.misses,
                warm=warm_replays(engines[H]),
                renders=float(np.median([x["renders"] for x in rs])),
                kernels=float(np.median([x["kernels"] for x in rs])),
                spans={name: _med_spread([x["spans"][name]["p50_ms"]
                                          for x in rs
                                          if name in x["spans"]])
                       for name in ("horizon_build", "adopt_wait", "emit")
                       if all(name in x["spans"] for x in rs)},
                span_max={name: max(x["spans"][name]["max_ms"] for x in rs
                                    if name in x["spans"])
                          for name in ("horizon_build", "adopt_wait",
                                       "emit")
                          if any(name in x["spans"] for x in rs)})
        for e in engines.values():
            e.drain_speculation()
            e.tracer.close()
        del engines
        H, why = decide_lookahead(rows, B)
        auto = engine_mod.resolve_lookahead("auto", B, "cuda")
        out[B] = dict(rows=rows, decided=H, why=why, auto=auto)
        for H_, r in rows.items():
            print(f"[{card}] policy B={B} H={H_}: realtime median "
                  f"{r['rt']:.3f}x spread {r['rt_spread']:.3f} (rounds "
                  f"{', '.join(f'{x:.3f}' for x in r['rt_rounds'])}); "
                  f"process_block ms p50 {r['p50'][0]:.4f} (spread "
                  f"{r['p50'][1]:.4f}), p99 {r['p99'][0]:.4f} "
                  f"({r['p99'][1]:.4f}), mean {r['mean'][0]:.4f} "
                  f"({r['mean'][1]:.4f}); misses {r['misses']} "
                  f"{json.dumps(r['kinds'])}; first block after warmup "
                  f"{json.dumps(r['first'])}; paced lag "
                  + (f"{r['lag']:.2f} ms (rounds "
                     f"{', '.join(f'{x:.2f}' for x in r['lag_rounds'])})"
                     if r["lag"] is not None else "not run")
                  + "; spans p50 (median, spread) / max ms: "
                  + (", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f})"
                               for k, v in r["spans"].items()) or "none")
                  + " / " + (", ".join(f"{k} {v:.4f}" for k, v in
                                       r["span_max"].items()) or "none")
                  + f"; renders {r['renders']:.3f} and kernels "
                  f"{r['kernels']:.2f} a block; {r['warm']}")
            label = f"policy B={B} H={H_}"
            print_misses(card, f"{label} first block", r.pop("first_misses"))
            r["causes"] = print_misses(card, label, r.pop("misses_named"))
        print(f"[{card}] policy B={B}: decided H={H} ({why}); the code's "
              f"auto on cuda resolves to H={auto} "
              f"({'agrees' if auto == H else 'differs'}) "
              f"({time.perf_counter() - t0:.1f} s)")
    return out


def policy_pump(device, card: str) -> dict:
    """The C ABI's wall-clock pump at B=128 (bench.measure_pump: null sink,
    per-block delivery, 5 s) at H in POLICY_PUMP_H, rounds rotated: its
    share of its periods, the copy wait and the deadline misses."""
    out = {H: [] for H in POLICY_PUMP_H}
    with tempfile.TemporaryDirectory() as tmp:
        wavs = bench.write_session_wavs(tmp)
        for r in range(POLICY_ROUNDS):
            for H in _rotated(POLICY_PUMP_H, r):
                with _env(LIBZL_TPU_LOOKAHEAD=H):
                    p = named_pump(device, wavs, card,
                                   f"policy pump B=128 H={H} round {r}")
                check(p["error"] is None, f"pump H={H}: {p['error']!r}")
                check(p["stats"]["spec_failures"] == 0,
                      f"pump H={H}: speculative build failed")
                out[H].append(dict(share=p["share"],
                                   wait=p["copy_wait"],
                                   kinds=p["stats"]["slo_by_kind"],
                                   causes=p["causes"]))
    res = {}
    for H, rs in out.items():
        kinds = {}
        for x in rs:
            kinds = _add_kinds(kinds, x["kinds"])
        share = _med_spread([x["share"] for x in rs])
        wait50 = _med_spread([x["wait"].get("p50_ms", float("nan"))
                              for x in rs])
        wait_max = max(x["wait"].get("max_ms", float("nan")) for x in rs)
        causes = {}
        for x in rs:
            for c, n in x["causes"].items():
                causes[c] = causes.get(c, 0) + n
        res[H] = dict(share=share, wait_p50=wait50, wait_max=wait_max,
                      kinds=kinds, misses=_misses(kinds), causes=causes)
        print(f"[{card}] policy pump B=128 H={H}: share of its periods "
              f"median {share[0]:.4f} spread {share[1]:.4f} (rounds "
              + ", ".join(f"{x['share']:.4f}" for x in rs)
              + f"); copy_wait "
              f"p50 median {wait50[0]:.4f} ms, max {wait_max:.4f} ms; "
              f"misses {res[H]['misses']} {json.dumps(kinds)}, by cause "
              f"{json.dumps(causes)}")
    return res


def policy_drain(device, card: str) -> dict:
    """The bounce drain: the bridge in process (LIBZL_TPU_NO_PUMP) with a
    null sink, the ABI session, K in POLICY_DRAIN_K set on one runtime
    between rounds (rotated), POLICY_DRAIN_BLOCKS blocks a round through
    step_blocks: ms a block and the flush phases; the K the rule picks
    (the smallest within POLICY_K_WITHIN of the best median)."""
    from libzl_tpu_torch.capi import bridge

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        wavs = bench.write_session_wavs(tmp)
        for B in (SUPER_BLOCK, LIVE_BLOCK):
            t0 = time.perf_counter()
            with _env(LIBZL_TPU_NO_PUMP=1, LIBZL_TPU_BACKEND=device,
                      LIBZL_TPU_VOICES=NUM_VOICES, LIBZL_TPU_BLOCK=B,
                      LIBZL_TPU_SINK="null"):
                bridge.init_engine()
            try:
                rt = bridge._rt()
                auto = rt.bounce_drain_blocks
                abi_session(bridge, wavs)
                rt.engine.warmup()
                rt.step_blocks(2 * max(POLICY_DRAIN_K))
                n = POLICY_DRAIN_BLOCKS[B]
                runs = {K: [] for K in POLICY_DRAIN_K}
                for r in range(POLICY_ROUNDS):
                    for K in _rotated(POLICY_DRAIN_K, r):
                        rt.bounce_drain_blocks = K
                        before = rt.phase_stats()
                        t1 = time.perf_counter()
                        rt.step_blocks(n)
                        ms = (time.perf_counter() - t1) / n * 1e3
                        after = rt.phase_stats()
                        runs[K].append(dict(ms=ms, phases={
                            k: after[k] - before.get(k, 0)
                            for k in after if k.startswith("flush")}))
                rt.engine.drain_speculation()
                H = rt.engine._lookahead
            finally:
                bridge.shutdown_engine()
            rows = {}
            for K, rs in runs.items():
                phases = {k: float(np.median([x["phases"].get(k, 0)
                                              for x in rs]))
                          for k in rs[0]["phases"]}
                rows[K] = dict(ms=_med_spread([x["ms"] for x in rs]),
                               rounds=[x["ms"] for x in rs], phases=phases)
            best = min(r["ms"][0] for r in rows.values())
            K = min(K for K, r in rows.items()
                    if r["ms"][0] <= best * (1 + POLICY_K_WITHIN))
            res[B] = dict(rows=rows, decided=K, auto=auto, lookahead=H)
            for K_, r in rows.items():
                print(f"[{card}] policy drain B={B} (H={H}) K={K_}: ms a "
                      f"block median {r['ms'][0]:.4f} spread "
                      f"{r['ms'][1]:.4f} (rounds "
                      f"{', '.join(f'{x:.4f}' for x in r['rounds'])}); "
                      f"flush phases over {n} blocks (median) "
                      f"{json.dumps(r['phases'])}")
            print(f"[{card}] policy drain B={B}: decided K={K} (the smallest "
                  f"within {100 * POLICY_K_WITHIN:g}% of the best median, "
                  f"{best:.4f} ms); the code's auto on cuda resolves to "
                  f"K={auto} ({'agrees' if auto == K else 'differs'}) "
                  f"({time.perf_counter() - t0:.1f} s)")
    return res


def phase_policy(device, card: str) -> dict:
    """The dispatch defaults on the card (PERF.md §5): lookahead H at three
    block sizes, H through the pump, the bounce drain's K; medians and
    spreads of interleaved rounds, and the decision
    each rule takes from them."""
    res = {}
    for name, fn in (("lookahead", policy_lookahead),
                     ("drain", policy_drain), ("pump", policy_pump)):
        t0 = time.perf_counter()
        res[name] = fn(device, card)
        print(f"policy {name}: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------- first blocks (18)

FIRST_BLOCKS = 8
FIRST_ENGINES = 2           # a setting
FIRST_ENGINES_FULL = 6      # under --first-blocks-only
# (label, B, engine options): the session's default engines at B=128
# (H=16) and B=1024 (H=0), the per-block engine at B=128 and a horizon
# engine at B=1024
FIRST_SETTINGS = (("default B=128", LIVE_BLOCK, {}),
                  ("default B=1024", SUPER_BLOCK, {}),
                  ("per-block B=128", LIVE_BLOCK, dict(lookahead=0)),
                  ("H=2 B=1024", SUPER_BLOCK, dict(lookahead=2)))
# the settings whose first blocks after a bank growth are measured too
GROW_SETTINGS = FIRST_SETTINGS[:2]


def grow_bank(e) -> None:
    """Load a clip that outgrows the engine's sound bank and play it: the
    next block uploads the grown bank and captures every graph again
    (RenderGraphs.rebind)."""
    from libzl_tpu_torch.io.wav import AudioData
    from libzl_tpu_torch.models.clip import ClipAudioSource

    n = e.bank.capacity_frames - e.bank._used + SAMPLE_RATE
    t = np.arange(n, dtype=np.float32) / SAMPLE_RATE
    wave = (0.3 * np.sin(2 * np.pi * 392.0 * t)).astype(np.float32)
    capacity = e.bank.capacity_frames
    clip = ClipAudioSource(e, audio=AudioData(wave[:, None], SAMPLE_RATE))
    check(e.bank.capacity_frames > capacity, "the bank did not grow")
    clip.play(loop=True, midi_channel=3)


def first_blocks_run(device, B: int, opts: dict, warm: bool,
                     want=None, grow: bool = False) -> dict:
    """A fresh engine of the session, warmed (or not) and synchronized,
    then FIRST_BLOCKS chained blocks under a BlockTracer with the
    allocator's counts. Each block's outputs are copied into buffers made
    before the first block (so holding them allocates nothing): `want`,
    the flat outputs of an engine never warmed, gives their sizes and
    what they must equal. With `grow`, FIRST_BLOCKS blocks run first, the
    counts are zeroed and grow_bank loads a clip before the traced blocks,
    whose kernels' launches are then held to the engine's dispatches
    (check_launches: None, or what failed). Returns the tracer's records,
    the engine's graph counts and the flat outputs (host)."""
    from libzl_tpu_torch.engine.graphs import flatten
    from libzl_tpu_torch.utils.profiling import SloCounter

    gc.collect()                # the engines before this one
    e = graph_engine(device, B, **opts)
    if warm:
        e.warmup()
    g = e._graphs
    if grow:
        for _ in range(FIRST_BLOCKS):
            e.process_block()
        e.drain_speculation()
        torch.cuda.synchronize()
        reset_counts([e])
        reset_launches()
        grow_bank(e)
    before = ((g.capture_seconds, e.stats().get("graph_warm_replays", 0))
              if grow else (0.0, 0))
    torch.cuda.synchronize()
    bufs = ([torch.empty(w.numel(), device=device) for w in want]
            if want is not None else None)
    e.slo = SloCounter(budget_seconds=B / SAMPLE_RATE)
    tracer = BlockTracer(e, keep=FIRST_BLOCKS, memory=True)
    outs = []
    try:
        for i in range(FIRST_BLOCKS):
            flat = flatten(e.process_block().outputs)
            if bufs is None:
                outs.append(torch.cat([t.reshape(-1) for t in flat]))
            else:
                torch.cat([t.reshape(-1) for t in flat], out=bufs[i])
        torch.cuda.synchronize()
        mem = tracer._mem()
    finally:
        tracer.close()
    e.drain_speculation()
    torch.cuda.synchronize()
    launch_fault = None
    if grow:
        try:
            check_launches(read_launches(), e.fetch_dispatches["windows"],
                           [e], "after the bank grew")
        except SmokeFailure as exc:
            launch_fault = str(exc)
    stats = e.stats()
    entries = list(g._entries.values())
    r = dict(blocks=tracer.blocks, misses=tracer.misses,
             collections=tracer.collections,
             mem=(tracer.blocks[0]["mem"][0], mem),
             graphs=len(entries),
             warmed=sum(1 for x in entries if getattr(x, "warmed", None)),
             warm_replays=stats.get("graph_warm_replays", 0) - before[1],
             capture_s=g.capture_seconds - before[0],
             late=stats["late_captures"],
             recaptures=stats["graph_recaptures"],
             launch_fault=launch_fault,
             outs=[t.cpu() for t in (bufs if bufs is not None else outs)])
    return r


def phase_first_blocks(device, card: str, engines: int) -> dict:
    """For each FIRST_SETTINGS setting, an engine never warmed, then
    `engines` engines built fresh, warmed and synchronized, each running
    FIRST_BLOCKS chained blocks (first_blocks_run). Held, on each: every
    captured graph warm-replayed, no late capture or recapture, the
    allocator's segment.all.allocated unchanged over the blocks, no
    generation-2 collection in them, every output bit-equal to the never
    warmed engine's. Printed: the first block's ms beside blocks 2-8's
    p50, its spans, the misses with their causes. Failed checks are
    gathered and raised at the end, after every setting printed."""
    failures = []
    res = {}
    print(f"[{card}] first blocks: switch interval "
          f"{sys.getswitchinterval() * 1e3:g} ms, {engines} engines a "
          f"setting, {FIRST_BLOCKS} chained blocks each")
    for label, B, opts in FIRST_SETTINGS:
        t0 = time.perf_counter()
        cold = first_blocks_run(device, B, opts, warm=False)
        runs = [first_blocks_run(device, B, opts, warm=True,
                                 want=cold["outs"])
                for _ in range(engines)]
        first = [r["blocks"][0]["ms"] for r in runs]
        # block 1 less the commands it applied (the session's start)
        bare = [r["blocks"][0]["ms"] - r["blocks"][0]["spans"].get(
            "commands", 0.0) for r in runs]
        rest = [float(np.percentile([b["ms"] for b in r["blocks"][1:]], 50))
                for r in runs]
        first_missed = sum(1 for r in runs if r["blocks"][0]["miss"])
        later = sum(len(r["misses"]) for r in runs) - first_missed
        for n, r in enumerate(runs):
            tag = f"first blocks {label} engine {n}"
            bad = []
            if r["warmed"] != r["graphs"]:
                bad.append(f"{r['warmed']} of {r['graphs']} graphs "
                           f"warm-replayed")
            if r["late"] or r["recaptures"]:
                bad.append(f"{r['late']} late captures, {r['recaptures']} "
                           f"recaptures")
            (seg0, retry0), (seg1, retry1) = r["mem"]
            if seg1 != seg0:
                grew = [b["block"] for b in r["blocks"]
                        if b["mem"][1][0] != b["mem"][0][0]]
                bad.append(f"segment.all.allocated {seg0} -> {seg1} "
                           f"(blocks {grew})")
            gen2 = [c for c in r["collections"] if c[0] == 2]
            if gen2:
                bad.append(f"{len(gen2)} generation-2 collections")
            diff = [i for i, (a, b) in enumerate(zip(r["outs"],
                                                     cold["outs"]))
                    if not torch.equal(a, b)]
            if diff:
                bad.append(f"blocks {diff} differ from the never-warmed "
                           f"engine")
            b0 = r["blocks"][0]
            print(f"[{card}] {tag}: block 1 {b0['ms']:.3f} ms "
                  f"({b0['miss']['cause'] if b0['miss'] else 'in time'}), "
                  f"blocks 2-{FIRST_BLOCKS} "
                  + " ".join(f"{b['ms']:.3f}" for b in r["blocks"][1:])
                  + f" ms; block 1 spans "
                  + ", ".join(f"{k} {v:.3f}" for k, v in b0["spans"].items()
                              if k != "process_block")
                  + f"; collections {[c[:2] for c in r['collections']]}; "
                  f"segments {seg0} -> {seg1}, alloc retries {retry0} -> "
                  f"{retry1}; {r['warmed']} of {r['graphs']} graphs "
                  f"warm-replayed ({r['warm_replays']} warm replays); "
                  + ("; ".join(bad) if bad else "checks hold"))
            for rec in r["misses"]:
                print(f"[{card}] {tag} miss: {miss_line(rec)}")
            failures += [f"{tag}: {x}" for x in bad]
        causes = {}
        for r in runs:
            for rec in r["misses"]:
                c = rec["miss"]["cause"]
                causes[c] = causes.get(c, 0) + 1
        res[label] = dict(first_ms=first, rest_p50_ms=rest,
                          first_less_commands_ms=bare,
                          first_missed=first_missed, later_misses=later,
                          causes=causes,
                          cold_first_ms=cold["blocks"][0]["ms"])
        print(f"[{card}] first blocks {label}: block 1 median "
              f"{np.median(first):.3f} ms (engines "
              + ", ".join(f"{x:.3f}" for x in first)
              + f"), less its commands {np.median(bare):.3f} ms, against "
              f"blocks 2-{FIRST_BLOCKS} p50 median {np.median(rest):.3f} ms "
              f"({np.median(first) / np.median(rest):.2f}x, less commands "
              f"{np.median(bare) / np.median(rest):.2f}x); "
              f"block 1 missed in {first_missed} of {len(runs)} engines, "
              f"blocks 2-{FIRST_BLOCKS} {later} misses; by cause "
              f"{json.dumps(causes)}; never warmed: block 1 "
              f"{cold['blocks'][0]['ms']:.3f} ms "
              f"({time.perf_counter() - t0:.1f} s)")
    for label, B, opts in GROW_SETTINGS:
        res[f"{label} after a bank growth"] = first_blocks_grown(
            device, card, label, B, opts, engines, failures)
    check(not failures, "; ".join(failures))
    return res


def first_blocks_grown(device, card: str, label: str, B: int, opts: dict,
                       engines: int, failures: list) -> dict:
    """The first blocks after a clip load that outgrows the bank
    (first_blocks_run with `grow`): an engine never warmed, then `engines`
    warmed ones. Block 1 uploads the grown bank and captures every graph
    again (rebind: the reference retraces there too); blocks 2-8 replay
    them. Held, on each warmed engine: every graph captured again and
    warm-replayed, no late capture, the launches equal to the dispatches
    with the warm launches apart, every output bit-equal to the never
    warmed engine's; failures go into `failures`. Printed: block 1's ms,
    capture seconds and warm replays, blocks 2-8's ms and the first
    realtime replays among them, each miss with its cause."""
    t0 = time.perf_counter()
    cold = first_blocks_run(device, B, opts, warm=False, grow=True)
    runs = [first_blocks_run(device, B, opts, warm=True, want=cold["outs"],
                             grow=True)
            for _ in range(engines)]
    for n, r in enumerate(runs):
        tag = f"first blocks {label} after a bank growth, engine {n}"
        bad = []
        if r["recaptures"] != r["graphs"] or not r["graphs"]:
            bad.append(f"{r['recaptures']} of {r['graphs']} graphs captured "
                       f"again")
        if r["warmed"] != r["graphs"]:
            bad.append(f"{r['warmed']} of {r['graphs']} graphs "
                       f"warm-replayed")
        if r["late"]:
            bad.append(f"{r['late']} late captures")
        if r["launch_fault"]:
            bad.append(r["launch_fault"])
        diff = [i for i, (a, b) in enumerate(zip(r["outs"], cold["outs"]))
                if not torch.equal(a, b)]
        if diff:
            bad.append(f"blocks {diff} differ from the never-warmed engine")
        b0 = r["blocks"][0]
        print(f"[{card}] {tag}: block 1 {b0['ms']:.3f} ms "
              f"({b0['miss']['cause'] if b0['miss'] else 'in time'}; "
              f"{b0['recaptures']} graphs captured again in "
              f"{r['capture_s'] * 1e3:.1f} ms, {r['warm_replays']} warm "
              f"replays), blocks 2-{FIRST_BLOCKS} "
              + " ".join(f"{b['ms']:.3f}" for b in r["blocks"][1:])
              + f" ms with {sum(b['first_replays'] for b in r['blocks'][1:])}"
              f" first realtime replays; block 1 spans "
              + ", ".join(f"{k} {v:.3f}" for k, v in b0["spans"].items()
                          if k != "process_block")
              + "; " + ("; ".join(bad) if bad else "checks hold"))
        for rec in r["misses"]:
            print(f"[{card}] {tag} miss: {miss_line(rec)}")
        failures += [f"{tag}: {x}" for x in bad]
    first = [r["blocks"][0]["ms"] for r in runs]
    rest = [float(np.percentile([b["ms"] for b in r["blocks"][1:]], 50))
            for r in runs]
    later = [sum(b["ms"] for b in r["blocks"][1:] if b["first_replays"])
             for r in runs]
    causes = {}
    for r in runs:
        for rec in r["misses"]:
            c = rec["miss"]["cause"]
            causes[c] = causes.get(c, 0) + 1
    print(f"[{card}] first blocks {label} after a bank growth: block 1 "
          f"median {np.median(first):.3f} ms (engines "
          + ", ".join(f"{x:.3f}" for x in first)
          + f"), blocks 2-{FIRST_BLOCKS} p50 median {np.median(rest):.3f} "
          f"ms, blocks with a first realtime replay {np.median(later):.3f} "
          f"ms in all (median); misses by cause {json.dumps(causes)} "
          f"({time.perf_counter() - t0:.1f} s)")
    return dict(first_ms=first, rest_p50_ms=rest, first_replay_ms=later,
                causes=causes)


@contextlib.contextmanager
def _phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", "--version", action="append", default=[],
                    metavar="NAME=PATH.cu[,FLAG...]",
                    help="also time this source of the windows fetch, the "
                         "lane mixdown, the voice prep, the voice post or "
                         "the finish (told by its C entry points) in phase "
                         "5, in turns with the port's (e.g. a parent "
                         "commit's copy); NAME is not kernel, plain, "
                         "library, empty or copy<n>")
    ap.add_argument("--mixdown-only", action="store_true",
                    help="run phases 1 and 2, then only the lane mixdown's "
                         "part of phase 3 and its timings of phase 5 (on "
                         "random contributions at the session's lanes)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1, 2 and 3 (every kernel against its "
                         "plain version) and stop")
    ap.add_argument("--graphs-only", action="store_true",
                    help="run phases 1 and 2, then only phase 16 (render "
                         "graphs)")
    ap.add_argument("--timing-only", action="store_true",
                    help="run phases 1 and 2, then only phase 5 (timings "
                         "and device profiles; run from inside another "
                         "checkout, a copy of this script times that "
                         "checkout's port)")
    ap.add_argument("--mesh-cards-only", action="store_true",
                    help="run phases 1 and 2, then only phase 13 across "
                         "every visible card (needs two or more)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run phases 1 and 2, then only phase 13 (meshes "
                         "on the first card, and across cards where there "
                         "are two or more)")
    ap.add_argument("--policy-only", action="store_true",
                    help="run phases 1 and 2, then only phase 17 (the "
                         "dispatch defaults' sweep: lookahead, bounce "
                         "drain, the pump's lookahead)")
    ap.add_argument("--first-blocks-only", action="store_true",
                    help="run phases 1 and 2, then only phase 18 (the "
                         "first blocks after warmup) with "
                         f"{FIRST_ENGINES_FULL} engines a setting")
    ap.add_argument("--switch-ms", type=float, default=None,
                    help="set the interpreter's switch interval to this "
                         "many ms before phase 1 (the pump sets 1)")
    ap.add_argument("--soak-seconds", type=float, default=20.0,
                    help="length of phase 14's pump soak")
    ap.add_argument("--soak-event-seconds", type=float, default=5.0,
                    help="seconds between phase 14's clip retriggers")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the GPU", file=sys.stderr)
        return 2
    device = "cuda"
    if opts.switch_ms is not None:
        sys.setswitchinterval(opts.switch_ms / 1e3)
    t_start = time.perf_counter()
    with _phase("1 environment"):
        card = phase_environment()
    with _phase("2 build"):
        phase_build()
        loaded = [load_version(spec) for spec in opts.compare]
        versions = {n: f for n, kind, f in loaded if kind == "fetch"}
        mix_versions = {n: f for n, kind, f in loaded if kind == "mixdown"}
        render_versions = {name: {n: f for n, kind, f in loaded
                                  if kind == name}
                           for name in RENDER_KERNELS}
    if opts.mesh_cards_only:
        with _phase("13 mesh across cards"):
            launches = phase_mesh_cards(card)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"mesh_cards_launches": launches,
                          "count": torch.cuda.device_count()}))
        return 0
    if opts.mesh_only:
        with _phase("13 mesh"):
            launches, mesh_timing = phase_mesh(device, card)
        print(f"mesh timing: {json.dumps(mesh_timing)}")
        print(f"mesh launches: {json.dumps(launches)}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if opts.policy_only:
        with _phase("17 policy"):
            policy = phase_policy(device, card)
        print(f"policy: {json.dumps(policy)}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if opts.first_blocks_only:
        with _phase("18 first blocks"):
            first = phase_first_blocks(device, card, FIRST_ENGINES_FULL)
        print(f"first blocks: {json.dumps(first)}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if opts.graphs_only:
        with _phase("16 graphs"):
            graphs = phase_graphs(device, card)
        print(f"graphs: {json.dumps(graphs)}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    check(not {"kernel", "plain", "library", "empty", "copy8", "copy4"}
          & {n for n, _, _ in loaded}, "reserved version name")
    if opts.timing_only:
        with _phase("5 timing"):
            timing = phase_timing(device, card, versions, mix_versions,
                                  render_versions)
        print(f"timing: {json.dumps(timing)}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if opts.mixdown_only:
        with _phase("3 kernel (mixdown)"):
            phase_mixdown(device)
        with _phase("5 timing (mixdown)"):
            rng = np.random.default_rng(8)
            timing = {}
            time_mixdowns(device, card, timing, {
                B: mixdown_inputs(rng, NUM_VOICES, B, 0, "session", False,
                                  device)
                for B in (SUPER_BLOCK, LIVE_BLOCK)}, mix_versions)
        print(f"timing: {json.dumps(timing)}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    with _phase("3 kernel"):
        err = phase_kernel(device)
        mix_err = phase_mixdown(device)
        render_err = phase_render_kernels(device)
    if opts.kernels_only:
        print(f"max abs errors: fetch {err:.3e}, mixdown {mix_err:.3e}, "
              f"{json.dumps(render_err)}")
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    with _phase("4 slice"):
        launches = phase_slice(device)
    with _phase("5 timing"):
        timing = phase_timing(device, card, versions, mix_versions,
                              render_versions)
    synthetic = f"{NUM_VOICES}x{SUPER_BLOCK}_synthetic"
    session = f"{NUM_VOICES}x{SUPER_BLOCK}_session"
    with _phase("6 default engine"):
        launches = add_launches(launches, phase_default_engine(device))
    with tempfile.TemporaryDirectory() as tmp:
        wavs = bench.write_session_wavs(tmp)
        with _phase("7 bridge"):
            launches = add_launches(launches, phase_bridge(device, wavs, tmp))
        with _phase("8 pump"):
            launches = add_launches(launches, phase_pump(device, wavs, card))
        with _phase("9 shim"):
            phase_shim()
        with _phase("10 thumbnails"):
            phase_thumbnails(device, card)
        with _phase("11 CLI"):
            phase_cli(device, wavs, tmp)
    with _phase("12 stretch"):
        stretch = phase_stretch(device, card)
    with _phase("13 mesh"):
        mesh_launches, mesh_timing = phase_mesh(device, card)
    launches = add_launches(launches, mesh_launches)
    with tempfile.TemporaryDirectory() as tmp, _phase("14 soak"):
        launches = add_launches(launches, phase_soak(
            device, card, tmp, opts.soak_seconds, opts.soak_event_seconds))
        phase_examples(device, tmp)
    with _phase("15 bench"):
        bench_line, bench_launches = phase_bench(card)
    launches = add_launches(launches, bench_launches)
    with _phase("16 graphs"):
        graphs = phase_graphs(device, card)
    launches = add_launches(launches, graphs["session"]["launches"])
    with _phase("18 first blocks"):
        first = phase_first_blocks(device, card, FIRST_ENGINES)
    print(f"timing: {json.dumps(timing)}")
    print(f"stretch: {json.dumps(stretch)}")
    print(f"mesh timing: {json.dumps(mesh_timing)}")
    print(f"bench: {json.dumps(bench_line)}")
    print(f"graphs: {json.dumps(graphs)}")
    print(f"first blocks: {json.dumps(first)}")
    print(f"launches on the main path (phases 4, 6, 7, 8, 13, 14, 15, 16): "
          f"{json.dumps(launches)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fetch_interp",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches["fetch_interp"],
        "max_abs_err": err,
        "inputs": SYNTHETIC_INPUTS,
        "ms": timing[f"kernel_ms_{synthetic}"],
        "plain_ms": timing[f"plain_ms_{synthetic}"],
        "bound_ms": timing[f"bound_ms_{synthetic}"],
        "bound_by": timing[f"bound_by_{synthetic}"],
        # the same call on the session's last per-block dispatch at B=1024
        "session_ms": timing[f"kernel_ms_{session}"],
        "session_plain_ms": timing[f"plain_ms_{session}"],
        "session_bound_ms": timing[f"bound_ms_{session}"],
        # no single PyTorch call computes this function: two regions, the
        # tap at p = region-1 crossing into region B, exact zeros outside
        # [0, 2*region-1) and the int16 dequantisation
        "library_ms": None,
    }, {
        "name": "lane_mixdown",
        "route": "cuda",
        "source": MIXDOWN_SOURCE,
        "replaces": MIXDOWN_REPLACES,
        "launches": launches["lane_mixdown"],
        "max_abs_err": mix_err,
        "inputs": MIXDOWN_INPUTS,
        "ms": timing[f"mix_kernel_ms_{session}"],
        "plain_ms": timing[f"mix_plain_ms_{session}"],
        "bound_ms": timing[f"mix_bound_ms_{session}"],
        "bound_by": timing[f"mix_bound_by_{session}"],
        # the one-hot torch.matmul the kernel replaces: the same function,
        # summed in cuBLAS's order
        "library_ms": timing[f"mix_library_ms_{session}"],
        # an empty kernel on the kernel's grid: the launch's share of `ms`
        "empty_launch_ms": timing[f"mix_empty_ms_{session}"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": render_err[name],
        "inputs": RENDER_INPUTS,
        "ms": timing[f"{name}_kernel_ms_{session}"],
        "plain_ms": timing[f"{name}_plain_ms_{session}"],
        "bound_ms": timing[f"{name}_bound_ms_{session}"],
        "bound_by": timing[f"{name}_bound_by_{session}"],
        # no single PyTorch call computes these functions: each is ~20 to
        # ~150 plain ops (the plain version)
        "library_ms": None,
    } for name, (source, replaces) in RENDER_KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
