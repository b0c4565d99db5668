#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (libzl_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--compare NAME=PATH.cu[,NVCC_FLAG...]] ...
    python3 chip_smoke.py --mesh-cards-only   # phases 1, 2, 13 across cards

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero:

1. environment — torch/CUDA/nvcc versions, the card's name and power limit;
   no CUDA device means exit 2 (this script never runs on the CPU);
2. build       — nvcc builds libzl_tpu_torch/csrc/*.cu for sm_90a;
3. kernel      — the windows fetch kernel against its plain PyTorch version
   on the card, at (V, B) = (1024, 128) and (1024, 1024), f32 and int16
   banks, with engine-like and hostile positions (atol 2e-6 / 3e-6,
   out-of-range lanes exactly 0); each call prints how many voice chunks
   the kernel stages in shared memory and how many exceed that budget and
   read their taps directly, and the hostile calls must have both;
4. slice       — the north-star session (1024 voices, 64 looped clips at
   48 kHz, 120 BPM; the port of bench.py's build_session) through the
   per-block engine (lookahead=0, voice buckets and ratio ladder off) on
   "cuda" (fetch resolves to the windows kernel) and on "cpu" (the plain
   gather path): 8 superblocks (B=1024), then 16 live blocks (B=128),
   every block compared (voice_peaks atol 2e-6; lane_mix and master rtol
   1e-5, atol 2e-6 x voices in the densest lane); the kernel's launch count
   must equal the dispatched blocks, and no block may fall back to gather;
5. timing      — per-block engine: superblock realtime factor, live-block
   ms, host program and dispatch ms, a torch.profiler pass per geometry
   (device ms and kernels per block, device busy share); default engine:
   realtime factor and ms/block at both geometries, SLO misses per kind,
   DSP load, the horizon-build / adoption-wait / emit spans, and a paced
   live run (one block per period); kernel and plain fetch ms on
   synthetic engine-like inputs and on the inputs of the session's last
   per-block dispatch, each beside its bound (the bytes its own inputs
   need at 3.35 TB/s, unique taps counted once) and the share of it
   reached, and the kernel at ratio rungs 2.0 and 4.0 (p50 over CUDA
   events: device time, and call time with the host's launch latency);
6. default engine — the session through the engine's default options
   (lookahead horizon, speculative chain, voice buckets, ratio ladder) on
   "cuda", at B=1024 (H=2) and B=128 (H=16), through a horizon build, at
   least two adoptions of the chain, and two preemptions (a note-off, then
   a set_strip, mid-horizon) rebuilt in their event block; every block is
   compared with a "cpu" engine at lookahead=0 (the rule of phase 4) and
   with a "cuda" engine at lookahead=0 with the same buckets (max
   difference printed); the kernel's launches must equal the horizon
   slices and per-block blocks rendered with the windows fetch, no gather
   fallback, no failed speculative build;
7. bridge       — the C ABI bridge (libzl_tpu_torch.capi.bridge) in process
   with LIBZL_TPU_NO_PUMP=1, 1024 voices, B=128: the 64 clips written as
   WAVs and loaded by clip_new, clip_play and timer_start, an in-memory
   non-pacing sink, 192 blocks with global-playback recording, then 192
   with a `lane:2` port recording added; on "cuda" with the bounce drain at
   its default (32) and at 1, and on "cpu". The two "cuda" sink streams are
   bit-equal; both, and the lane recording, agree with "cpu" (phase 4's
   rule); the kernel's launches equal the engines' windows dispatches;
8. pump         — the wall-clock pump on "cuda" for 5 s with a null sink and
   per-block delivery, the session loaded while it runs: no pump error, no
   failed speculative build; blocks rendered against block periods,
   phase_stats, SLO misses per kind and the per-block copy wait printed;
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
   mesh=make_mesh(devices=["cuda:0"] * k)) for k = 2 and 4, at B=1024 and
   B=128, per-block (lookahead=0) and with the default options, every block
   against the unsharded "cuda" engine of the same options (phase 4's
   rule); the windows kernel's launches must equal the unsharded engine's
   windows blocks plus k x each mesh engine's; each shard's kernel call (V/k
   voices) bit-equal to the plain version; realtime factor and process_block
   ms per k; across every card where there are two or more (per-block at
   B=1024 and default at B=128, each card's kernel held to its plain version
   on that card).

Every phase prints its wall seconds. The line before the last holds the
kernel record as JSON (its launches are
those of phases 4, 6, 7, 8 and 13, each counted from 0 around its run; `ms`,
`plain_ms` and `bound_ms` are those of the fixed synthetic inputs named by
its `inputs`, the `session_` keys those of the session's last per-block
dispatch at B=1024); the last line is {"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

NUM_VOICES = 1024
NUM_CLIPS = 64
SAMPLE_RATE = 48000
SUPER_BLOCK = 1024
LIVE_BLOCK = 128
SLICE_SUPER_BLOCKS = 8
SLICE_LIVE_BLOCKS = 16
# phases 4 and 5 drive the per-block engine (their figures stay comparable
# with the per-block records in PERF.md); phase 6 the default options
PER_BLOCK = dict(lookahead=0, voice_buckets="off", ratio_ladder="off")
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


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def session_plan(sr: int, num_voices: int = NUM_VOICES,
                 num_clips: int = NUM_CLIPS):
    """bench.py's session, drawn from seed 0: `num_clips` two-partial sine
    clips of 0.4-2 s ([T, 1] f32) and one looped ClipCommand per voice
    across 10 channels, as `make_command(clip_id)` callables."""
    from libzl_tpu_torch.engine.commands import ClipCommand

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


def build_session(engine, num_voices: int = NUM_VOICES,
                  num_clips: int = NUM_CLIPS):
    """bench.py's build_session on a given engine: session_plan's clips and
    voices, transport started at 120 BPM."""
    from libzl_tpu_torch.io.wav import AudioData
    from libzl_tpu_torch.models.clip import ClipAudioSource

    sr = engine.sample_rate
    engine.start_transport(bpm=120)
    waves, voices = session_plan(sr, num_voices, num_clips)
    clips = [ClipAudioSource(engine, audio=AudioData(w, sr)) for w in waves]
    for i, make_command in voices:
        engine.schedule_clip_command(make_command(clips[i].id), 0)
    return clips


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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phases


def phase_environment() -> str:
    from libzl_tpu_torch import _build

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-2] if len(nvcc) > 1 else nvcc[-1]}")
    card = card_line()
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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    torch.cuda.synchronize()


def kernel_inputs(rng, V: int, B: int, n: int, dtype, hostile: bool,
                  device, r_max: float = 4.0):
    """Random bank, windows and window-relative positions for regions of
    region_rows(B, r_max). Engine-like draws keep each voice's positions
    inside its regions at one whole-sample pitch ratio up to r_max, each
    frame in region A or B at random; hostile draws add negative,
    past-the-end and region-edge positions (p = region-1 reads region B's
    first sample at tap p+1; 2*region-2 is the last valid position,
    2*region-1 the first invalid one)."""
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


def phase_slice(device) -> int:
    from libzl_tpu_torch.engine.engine import AudioEngine
    from libzl_tpu_torch.ops import fetch_windows as fw

    pairs = []
    for B, n in ((SUPER_BLOCK, SLICE_SUPER_BLOCKS),
                 (LIVE_BLOCK, SLICE_LIVE_BLOCKS)):
        gpu = AudioEngine(device, sample_rate=SAMPLE_RATE, block_frames=B,
                          num_voices=NUM_VOICES, **PER_BLOCK)
        cpu = AudioEngine("cpu", sample_rate=SAMPLE_RATE, block_frames=B,
                          num_voices=NUM_VOICES, **PER_BLOCK)
        check(gpu.fetch == "windows" and cpu.fetch == "gather",
              f"fetch resolved to {gpu.fetch}/{cpu.fetch}")
        build_session(gpu)
        build_session(cpu)
        gpu.warmup()
        pairs.append((B, n, gpu, cpu))
    torch.cuda.synchronize()

    fw.fetch_interp.launches = 0
    for B, n, gpu, cpu in pairs:
        t0 = time.perf_counter()
        worst = _compare_blocks(gpu, cpu, n, f"B={B}")
        print(f"slice B={B}: {n} blocks, active voices "
              f"{int(gpu.pool.active.sum())}, densest lane "
              f"{_densest_lane(gpu)}, max err "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f" ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    launches = fw.fetch_interp.launches

    windows = sum(g.fetch_dispatches["windows"] for _, _, g, _ in pairs)
    gather = sum(g.fetch_dispatches["gather"] for _, _, g, _ in pairs)
    print(f"slice: kernel launches {launches}, dispatched blocks windows "
          f"{windows} gather {gather}")
    check(gather == 0, "a block fell back to the gather fetch")
    check(windows == SLICE_SUPER_BLOCKS + SLICE_LIVE_BLOCKS,
          f"{windows} dispatched blocks, expected every block")
    check(launches == windows,
          f"kernel launched {launches} times for {windows} blocks")
    return launches


# (B, blocks, note-off block, set_strip block): the first horizon starts
# after 3 clean blocks, the chain is adopted at every exhaustion, and both
# events land mid-horizon at least 3 blocks after the last one, so each
# preempts the horizon and rebuilds it in its event block
DEFAULT_RUNS = ((SUPER_BLOCK, 18, 10, 15), (LIVE_BLOCK, 66, 40, 48))


def default_engines(device, B: int):
    """(default engine on `device`, per-block engine with the same buckets
    and ladder on `device`, per-block engine on "cpu"), each with the
    session built; the device engines warmed up."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    def make(dev, **opts):
        e = AudioEngine(dev, sample_rate=SAMPLE_RATE, block_frames=B,
                        num_voices=NUM_VOICES, **opts)
        build_session(e)
        return e

    hz = make(device)
    pb = make(device, lookahead=0)
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


def phase_default_engine(device) -> int:
    from libzl_tpu_torch.ops import fetch_windows as fw

    runs = []
    for B, n, off_at, strip_at in DEFAULT_RUNS:
        hz, pb, cpu = default_engines(device, B)
        check(hz._lookahead == min(16, 2048 // B) and hz.fetch == "windows"
              and hz._ratio_ladder == [2.0, 4.0]
              and hz._bucket_ladder == [64, 128, 256, 512, 1024],
              f"default options resolved to lookahead {hz._lookahead}, "
              f"fetch {hz.fetch}, rungs {hz._ratio_ladder}, buckets "
              f"{hz._bucket_ladder}")
        runs.append((B, n, off_at, strip_at, hz, pb, cpu))
    torch.cuda.synchronize()
    total = 0
    for B, n, off_at, strip_at, hz, pb, cpu in runs:
        for e in (hz, pb):
            e.fetch_dispatches = {"windows": 0, "gather": 0}
        t0 = time.perf_counter()
        fw.fetch_interp.launches = 0
        r = drive_default(hz, pb, cpu, n, off_at, strip_at)
        torch.cuda.synchronize()
        launches = fw.fetch_interp.launches
        windows = hz.fetch_dispatches["windows"] + pb.fetch_dispatches[
            "windows"]
        gather = hz.fetch_dispatches["gather"] + pb.fetch_dispatches["gather"]
        stats = hz.stats()
        print(f"default B={B} H={hz._lookahead}: {n} blocks, horizons "
              f"{r['horizons']}, adoptions {r['adoptions']}, event rebuilds "
              f"{r['rebuilds']}, preemptions {r['preempted']} (rebuilt "
              f"{r['rebuilt']}); vs cpu max err "
              + ", ".join(f"{k} {v:.3e}" for k, v in r["worst"].items())
              + f"; vs cuda lookahead=0 max |diff| {r['worst_pb']:.3e}"
              f"{' (bit-equal)' if r['worst_pb'] == 0.0 else ''}; kernel "
              f"launches {launches}, rendered blocks windows {windows} "
              f"(horizon engine {hz.fetch_dispatches['windows']}) gather "
              f"{gather}; spec failures {stats['spec_failures']} "
              f"({time.perf_counter() - t0:.1f} s)")
        check(stats["spec_failures"] == 0,
              f"speculative build failed: {stats['spec_last_failure']}")
        check(r["horizons"] >= 1 and r["adoptions"] >= 2,
              f"B={B}: {r['horizons']} horizons, {r['adoptions']} adoptions")
        check(r["preempted"] >= 2 and r["rebuilt"] >= 2,
              f"B={B}: {r['preempted']} preemptions, {r['rebuilt']} rebuilt")
        check(gather == 0, "a block fell back to the gather fetch")
        check(launches == windows,
              f"kernel launched {launches} times for {windows} rendered "
              f"blocks")
        total += launches
    return total


def _events_ms(fn, iters: int, primed: bool) -> list:
    """Per-call ms over CUDA events, one event pair per call, with the 50 MB
    L2 flushed before each call (the render's other tensors evict the
    bank's windows between fetches). `primed` queues a ~2.5 ms device spin
    after the flush, so the host enqueues the call (the plain version's ~20
    ops included) while the card is busy and the pair brackets device
    execution only; unprimed, the pair also
    holds the host's launch latency (the card idles while the host
    launches)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        if primed:
            torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _device_profile(engine, n_blocks: int) -> dict:
    """Device time per block from torch.profiler's CUDA kernel events over
    `n_blocks` chained blocks: total, kernel launches, and the fetch
    kernel's share. Empty when the profiler sees no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_blocks):
            engine.process_block()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in dev)
    if device_us <= 0:
        return {}
    fetch_us = sum(e.self_device_time_total for e in dev
                   if "fetch_interp_kernel" in e.key)
    return {
        "device_ms": device_us / n_blocks / 1e3,
        "kernels": sum(e.count for e in dev) / n_blocks,
        "fetch_share": fetch_us / device_us,
    }


def _print_profile(card: str, label: str, prof: dict, block_ms: float):
    if not prof:
        print(f"[{card}] {label} device profile: not measured (no device "
              f"events in the profiler)")
        return
    print(f"[{card}] {label} device profile: {prof['device_ms']:.4f} ms "
          f"device per block, {prof['kernels']:.1f} kernels per block, fetch "
          f"kernel {100 * prof['fetch_share']:.2f}% of device time; device "
          f"busy {100 * prof['device_ms'] / block_ms:.1f}% of the "
          f"unprofiled process_block time ({block_ms:.4f} ms)")


HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def fetch_bound(args, r_max: float = 4.0) -> dict:
    """The least time the card could take for one windows fetch on these
    inputs: each input byte read once and each output byte written once
    (pos and alpha 8 B and the output 8 B a (voice, frame), the windows 8 B
    a voice, and the bank samples the valid frames tap, each unique sample
    of both channels once), against the float32 work (per frame and
    channel: the int16 dequant of two taps, two products and a sum)."""
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    sound, pos, _, win_a, win_b = args
    V, B = pos.shape
    region = region_rows(B, r_max)
    n = sound.shape[1]
    p = pos.long()
    valid = (p >= 0) & (p < 2 * region - 1)
    base_a = win_a.long()[:, None] * 512
    base_b = win_b.long()[:, None] * 512 - region
    taps = torch.cat([torch.where(t < region, base_a + t, base_b + t)[valid]
                      for t in (p, p + 1)])
    taps = taps[(taps >= 0) & (taps < n)]
    unique = int(torch.unique(taps).numel())
    nbytes = 16 * V * B + 8 * V + unique * 2 * sound.element_size()
    ops = V * B * 2 * (3 + (2 if sound.dtype == torch.int16 else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "unique_taps": unique,
            "valid_frames": int(valid.sum()),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def capture_fetches(engine) -> list:
    """One more block of `engine`; returns (args, r_max) of each windows
    fetch call it made (one per shard under a mesh)."""
    from libzl_tpu_torch.ops import voice

    calls = []
    real = voice.fetch_interp

    def spy(*args, **kw):
        calls.append((args, kw.get("r_max", 4.0)))
        return real(*args, **kw)

    voice.fetch_interp = spy
    try:
        engine.process_block()
    finally:
        voice.fetch_interp = real
    torch.cuda.synchronize()
    return calls


def capture_fetch(engine) -> tuple:
    """(args, r_max) of the windows fetch call of one more block of a
    one-device per-block engine: the session's last per-block dispatch."""
    calls = capture_fetches(engine)
    check(len(calls) == 1, f"{len(calls)} fetch calls in one block")
    return calls[-1]


def load_version(spec: str) -> tuple:
    """`name=path.cu[,nvcc flag,...]`: another source with the windows
    kernel's C entry points (a parent commit's copy, say), built with the
    port's nvcc flags plus the given ones into build/libzl_tpu_torch/
    versions/; returns (name, a function with fetch_interp's arguments that
    launches it, counting nothing)."""
    import ctypes

    from libzl_tpu_torch import _build
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    name, rest = spec.split("=", 1)
    path, *flags = rest.split(",")
    src = Path(path).resolve()
    so = _build._hashed(f"fetch_{name}", [src], _build.NVCC_FLAGS + flags,
                        _build.BUILD_DIR / "versions")
    if not so.is_file():
        nvcc = _build.find_nvcc()
        _build._compile(lambda out: [nvcc, *_build.NVCC_FLAGS, *flags, "-o",
                                     out, str(src)], so, f"nvcc {name}")
    lib = _build.bind_fetch(ctypes.CDLL(str(so)))

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

    print(f"version {name}: {src}{' ' + ' '.join(flags) if flags else ''}")
    return name, fetch


def phase_timing(device, card: str, versions: dict) -> dict:
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
    session = {SUPER_BLOCK: capture_fetch(eng)}
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
    session[LIVE_BLOCK] = capture_fetch(live)
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
    _print_profile(card, "superblock", super_profile,
                   res["super_process_block_ms_p50"])
    _print_profile(card, "live block", live_profile,
                   lprof["process_block"]["p50_ms"])
    res.update({f"super_profile_{k}": v for k, v in super_profile.items()})
    res.update({f"live_profile_{k}": v for k, v in live_profile.items()})

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

    # the ratio ladder's rungs: the kernel at region_rows(B, 2.0) against
    # region_rows(B, 4.0) on the SAME taps (pitch ratios <= 2; region B's
    # positions re-based from one region size to the other), in turns
    for V, B in ((NUM_VOICES, LIVE_BLOCK), (NUM_VOICES, SUPER_BLOCK)):
        args2 = kernel_inputs(np.random.default_rng(7), V, B, BANK_FRAMES,
                              torch.float32, False, device, r_max=2.0)
        r2, r4 = fw.region_rows(B, 2.0), fw.region_rows(B, 4.0)
        pos = args2[1]
        args4 = (args2[0], torch.where(pos >= r2, pos - r2 + r4, pos)
                 .contiguous(), *args2[2:])
        check(torch.equal(fw.fetch_interp(*args2, r_max=2.0),
                          fw.fetch_interp(*args4, r_max=4.0)),
              "the rungs read different taps")
        fns = {2.0: lambda: fw.fetch_interp(*args2, r_max=2.0),
               4.0: lambda: fw.fetch_interp(*args4, r_max=4.0)}
        for f in fns.values():
            for _ in range(5):
                f()
        samples = {2.0: [], 4.0: []}
        for r in (2.0, 4.0, 4.0, 2.0):
            samples[r] += _events_ms(fns[r], 25, True)
        for r in (2.0, 4.0):
            res[f"kernel_ms_{V}x{B}_rmax{r:g}"] = float(
                np.median(samples[r]))
        print(f"[{card}] fetch kernel V={V} B={B} device time by ratio rung: "
              f"rmax 2.0 {res[f'kernel_ms_{V}x{B}_rmax2']:.4f} ms, rmax 4.0 "
              f"{res[f'kernel_ms_{V}x{B}_rmax4']:.4f} ms (same taps, "
              f"bit-equal outputs; p50 of 50 each, in turns)")
    torch.cuda.synchronize()
    return res


def _spans(engine) -> dict:
    prof = engine.profiler.summary()
    return {name: {k: prof[name][k] for k in ("p50_ms", "max_ms", "count")}
            for name in ("process_block", "horizon_build", "adopt_wait",
                         "emit") if name in prof}


def _default_timing(device, card: str, res: dict) -> None:
    """The default engine (horizon, chain, buckets, ladder) at both
    geometries: realtime factor and ms/block over chained blocks (one sync
    at the end), SLO misses per kind, DSP load, the lookahead spans, a
    device profile; at B=128 also a paced run, one block per period."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    def engine(B):
        e = AudioEngine(device, sample_rate=SAMPLE_RATE, block_frames=B,
                        num_voices=NUM_VOICES)
        build_session(e)
        e.warmup()
        for _ in range(3 + 4 * e._lookahead):   # past the first adoptions
            e.process_block()
        torch.cuda.synchronize()
        return e

    for B, n, rounds_n in ((SUPER_BLOCK, 40, 3), (LIVE_BLOCK, 320, 1)):
        e = engine(B)
        tag = f"default_{B}"
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
        prof = _device_profile(e, 4 * e._lookahead)
        res.update({f"{tag}_profile_{k}": v for k, v in prof.items()})
        print(f"[{card}] default engine B={B} H={e._lookahead}: realtime "
              f"factor {res[f'{tag}_rt']:.3f}x (rounds "
              f"{', '.join(f'{r:.3f}' for r in rts)}), process_block ms p50 "
              f"{res[f'{tag}_ms_p50']:.4f} mean {res[f'{tag}_ms_mean']:.4f} "
              f"(chained, {rounds_n}x{n} blocks); dsp_load "
              f"{stats['dsp_load']}; spec failures {stats['spec_failures']}")
        print(f"[{card}] default engine B={B} slo_by_kind (missed, total, "
              f"worst overrun ms): {json.dumps(stats['slo_by_kind'])}")
        print(f"[{card}] default engine B={B} spans: "
              f"{json.dumps(res[f'{tag}_spans'])}")
        # emits make the p50 tiny: the busy share is over the mean
        _print_profile(card, f"default engine B={B}", prof,
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


# ----------------------------------------------- the C ABI slice (7-11)

BRIDGE_BLOCKS = 384        # per run: half with global recording (drained),
                           # half with a lane port recording (per block)
PUMP_SECONDS = 5.0
ABI_PLAY_CHANNEL = -2      # ClipAudioSource_play's channel (lane 0)


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


@contextlib.contextmanager
def _env(**values):
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


def write_session_wavs(tmp: str) -> list:
    from libzl_tpu_torch.io.wav import write_wav

    waves, _ = session_plan(SAMPLE_RATE)
    paths = []
    for i, w in enumerate(waves):
        paths.append(f"{tmp}/clip{i:02d}.wav")
        write_wav(paths[-1], w, SAMPLE_RATE)
    return paths


def abi_session(bridge, wavs: list) -> None:
    """The north-star session through the C entry points: the 64 clips by
    clip_new and clip_play (one looped voice each, on the ABI's play
    channel), the other 960 voices as scheduled looped ClipCommands under
    the runtime lock (as an embedding host schedules notes), timer_start."""
    rt = bridge._rt()
    ids = [bridge.clip_new(p) for p in wavs]
    for cid in ids:
        bridge.clip_play(cid, True, ABI_PLAY_CHANNEL)
    _, voices = session_plan(SAMPLE_RATE, NUM_VOICES - len(ids))
    for i, make_command in voices:
        cmd = make_command(ids[i])
        rt.run_locked(lambda cmd=cmd: rt.engine.schedule_clip_command(cmd, 0))
    bridge.timer_start(120)


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
            densest=_densest_lane(engine), drain=rt.bounce_drain_blocks,
            phases=rt.phase_stats(), stats=engine.stats())
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


def phase_bridge(device, wavs: list, tmp: str) -> int:
    from libzl_tpu_torch.ops import fetch_windows as fw

    fw.fetch_interp.launches = 0
    runs = {k: bridge_run(device, k, wavs, tmp) for k in ("auto", 1)}
    torch.cuda.synchronize()
    launches = fw.fetch_interp.launches
    ref = bridge_run("cpu", 1, wavs, tmp)
    drained, plain = runs["auto"], runs[1]
    check(drained["drain"] == 32 and plain["drain"] == 1,
          f"bounce drain resolved to {drained['drain']}/{plain['drain']}")
    frames = BRIDGE_BLOCKS * LIVE_BLOCK
    for r in (drained, plain, ref):
        check(r["stream"].shape == (frames, 2), f"sink got "
              f"{r['stream'].shape[0]} frames, expected {frames}")
        check(r["lane"].shape == (frames // 2, 2), "lane recording frames")
    check(np.array_equal(drained["stream"], plain["stream"]),
          "drain-32 sink stream differs from drain-1")
    atol = MIX_ATOL_PER_VOICE * max(ref["densest"], plain["densest"], 1)
    errs = [_close(r["stream"], ref["stream"], atol, f"bridge {k} vs cpu")
            for k, r in runs.items()]
    lane_err = _close(plain["lane"], ref["lane"], atol, "lane recording")
    peak = float(np.abs(plain["lane"]).max())
    check(peak > 0.05, f"lane recording silent (peak {peak})")
    check(float(np.abs(plain["stream"]).max()) > 0.05, "silent sink stream")
    windows = sum(r["dispatches"]["windows"] for r in runs.values())
    gather = sum(r["dispatches"]["gather"] for r in runs.values())
    for k, r in runs.items():
        check(r["stats"]["spec_failures"] == 0,
              f"drain {k}: speculative build failed")
        print(f"bridge {device} drain {r['drain']}: {BRIDGE_BLOCKS} blocks "
              f"in {r['seconds']:.1f} s (incl. init + 64 clip loads); "
              f"phases {json.dumps(r['phases'])}")
    print(f"bridge: drain-32 == drain-1 (bit-equal); vs cpu (densest lane "
          f"{ref['densest']} voices, atol {atol:.1e}) max err "
          f"{max(errs):.3e}; lane:2 recording peak {peak:.3f} max err "
          f"{lane_err:.3e}; kernel launches {launches}, rendered blocks "
          f"windows {windows} gather {gather}; cpu run "
          f"{ref['seconds']:.1f} s")
    check(gather == 0, "a block fell back to the gather fetch")
    check(launches == windows, f"kernel launched {launches} times for "
          f"{windows} rendered blocks")
    torch.cuda.synchronize()
    return launches


def phase_pump(device, wavs: list, card: str) -> int:
    """The wall-clock pump on the card with a null sink and per-block
    delivery (bounce drain 1: what a pacing sink gets), the session loaded
    while it runs; PUMP_SECONDS of it measured."""
    from libzl_tpu_torch.capi import bridge
    from libzl_tpu_torch.ops import fetch_windows as fw

    fw.fetch_interp.launches = 0
    with _env(LIBZL_TPU_NO_PUMP=None, LIBZL_TPU_BACKEND=device,
              LIBZL_TPU_VOICES=NUM_VOICES, LIBZL_TPU_BLOCK=LIVE_BLOCK,
              LIBZL_TPU_BOUNCE_DRAIN=1, LIBZL_TPU_SINK="null"):
        bridge.init_engine()
    try:
        rt = bridge._rt()
        engine = rt.engine
        check(rt._pump is not None, "the pump did not start")
        abi_session(bridge, wavs)
        b0, t0 = engine.total_blocks, time.perf_counter()
        time.sleep(PUMP_SECONDS)
        blocks = engine.total_blocks - b0
        wall = time.perf_counter() - t0
        rt.stop_pump()
        engine.drain_speculation()
        stats = engine.stats()
        waits = rt.profiler.summary().get("copy_wait", {})
        error = rt.pump_error
    finally:
        bridge.shutdown_engine()
    torch.cuda.synchronize()
    launches = fw.fetch_interp.launches
    period = LIVE_BLOCK / SAMPLE_RATE
    print(f"[{card}] pump (1024 voices, B=128, null sink, per-block "
          f"delivery): {blocks} blocks rendered in {wall:.2f} s of wall "
          f"time = {wall / period:.0f} block periods ({blocks * period / wall:.3f}x "
          f"realtime); kernel launches {launches}")
    print(f"[{card}] pump copy wait p50 {waits.get('p50_ms', float('nan')):.4f} "
          f"ms, max {waits.get('max_ms', float('nan')):.4f} ms over "
          f"{waits.get('count', 0)} blocks")
    print(f"[{card}] pump phase_stats {json.dumps(rt.phase_stats())}")
    print(f"[{card}] pump slo_by_kind {json.dumps(stats['slo_by_kind'])}; "
          f"dsp_load {stats['dsp_load']}")
    check(error is None, f"pump error: {error!r}")
    check(stats["spec_failures"] == 0,
          f"speculative build failed: {stats['spec_last_failure']}")
    check(launches > 0, "the pump never launched the kernel")
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


def mesh_engines(device, B: int, opts: dict, meshes: dict) -> dict:
    """{k: engine} with the session built and warmed: k=1 the unsharded
    engine on `device`, else an engine on meshes[k]."""
    from libzl_tpu_torch.engine.engine import AudioEngine

    out = {}
    for k, mesh in meshes.items():
        dev = device if mesh is None else mesh.devices[0]
        e = AudioEngine(dev, sample_rate=SAMPLE_RATE, block_frames=B,
                        num_voices=NUM_VOICES, mesh=mesh, **opts)
        build_session(e)
        e.warmup()
        out[k] = e
    return out


def drive_mesh(engines: dict, n: int, label: str) -> dict:
    """Drive every engine `n` blocks in lockstep, each mesh engine held to
    the unsharded one (engines[1]) every block under phase 4's rule."""
    worst = {}
    ref = engines[1]
    for i in range(n):
        before = _densest_lane(ref)
        outs = {k: e.process_block().outputs for k, e in engines.items()}
        mix_atol = MIX_ATOL_PER_VOICE * max(before, _densest_lane(ref), 1)
        for k, o in outs.items():
            if k != 1:
                _check_block(o, outs[1], mix_atol, f"{label} k={k} block {i}",
                             worst.setdefault(k, {}))
    for e in engines.values():
        e.drain_speculation()
    return worst


def time_mesh(e, n: int) -> dict:
    """Realtime factor over `n` chained blocks (one sync at the end) and
    the process_block p50 of those blocks."""
    from libzl_tpu_torch.utils.profiling import BlockProfiler

    e.profiler = BlockProfiler()
    t0 = time.perf_counter()
    for _ in range(n):
        out = e.process_block()
    out.outputs.master.cpu()
    wall = time.perf_counter() - t0
    e.drain_speculation()
    return {"rt": n * e.block_frames / SAMPLE_RATE / wall,
            "ms_p50": e.profiler.summary()["process_block"]["p50_ms"]}


def check_shard_kernels(engine, k: int) -> int:
    """Each shard's windows fetch of one more block against the plain
    version: bit-equal (phase 3's rule for the kernel). Returns the
    per-shard voice count."""
    from libzl_tpu_torch.ops import fetch_windows as fw

    calls = capture_fetches(engine)
    check(len(calls) == k, f"{len(calls)} fetch calls for {k} shards")
    for args, r_max in calls:
        check(torch.equal(fw.fetch_interp(*args, r_max=r_max),
                          fw.fetch_interp_plain(*args, r_max=r_max)),
              f"shard kernel at V={args[1].shape[0]} differs from plain")
    return int(calls[0][0][1].shape[0])


def phase_mesh(device, card: str) -> tuple:
    from libzl_tpu_torch.ops import fetch_windows as fw
    from libzl_tpu_torch.parallel.sharding import canonical_device, make_mesh

    first = canonical_device(device)
    meshes = {1: None}
    meshes.update({k: make_mesh(devices=[first] * k) for k in MESH_SHARDS})
    total, timing = 0, {}
    for mode, opts in (("per-block", dict(lookahead=0)), ("default", {})):
        for B, n in MESH_RUNS:
            t0 = time.perf_counter()
            engines = mesh_engines(first, B, opts, meshes)
            for k, e in engines.items():
                check(e.fetch == "windows", f"k={k}: fetch {e.fetch}")
                e.fetch_dispatches = {"windows": 0, "gather": 0}
            torch.cuda.synchronize()
            fw.fetch_interp.launches = 0
            worst = drive_mesh(engines, n, f"mesh {mode} B={B}")
            torch.cuda.synchronize()
            launches = fw.fetch_interp.launches
            windows = {k: e.fetch_dispatches["windows"]
                       for k, e in engines.items()}
            gather = sum(e.fetch_dispatches["gather"]
                         for e in engines.values())
            expect = sum(k * w for k, w in windows.items())
            check(gather == 0, "a mesh block fell back to the gather fetch")
            check(launches == expect, f"kernel launched {launches} times, "
                  f"expected shards x windows blocks = {expect}")
            for k, e in engines.items():
                check(e.stats()["spec_failures"] == 0,
                      f"k={k}: speculative build failed: "
                      f"{e.stats()['spec_last_failure']}")
            total += launches
            shard_v = {k: check_shard_kernels(engines[k], k)
                       for k in MESH_SHARDS if not engines[k]._lookahead}
            for k, e in engines.items():
                timing[(mode, B, k)] = time_mesh(e, 20 if B == SUPER_BLOCK
                                                 else 96)
                if not e._lookahead:
                    timing[(mode, B, k)].update(_device_profile(e, 10))
            print(f"mesh {mode} B={B} H={engines[1]._lookahead}: {n} blocks; "
                  + "; ".join(f"k={k} max err " + ", ".join(
                      f"{a} {v:.3e}" for a, v in worst[k].items())
                      for k in MESH_SHARDS)
                  + f"; windows blocks {windows}, kernel launches {launches}"
                  f" (= sum of k x blocks)"
                  + (f"; shard kernels bit-equal to plain at V="
                     f"{sorted(shard_v.values())}" if shard_v else "")
                  + f" ({time.perf_counter() - t0:.1f} s)")
            print(f"[{card}] mesh {mode} B={B}: "
                  + "; ".join(f"k={k} realtime {t['rt']:.3f}x, process_block "
                              f"p50 {t['ms_p50']:.4f} ms"
                              + (f", device {t['device_ms']:.4f} ms and "
                                 f"{t['kernels']:.0f} kernels a block"
                                 if "device_ms" in t else "")
                              for k in engines
                              for t in [timing[(mode, B, k)]])
                  + " (chained blocks, one sync at the end; device from "
                  "torch.profiler over 10 more)")
            del engines
    if torch.cuda.device_count() >= 2:
        total += phase_mesh_cards(card)
    else:
        print("mesh across cards: NOT RUN: one card")
    torch.cuda.synchronize()
    return total, {f"{m}_{b}_k{k}": v for (m, b, k), v in timing.items()}


def sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_mesh_cards(card: str) -> int:
    """Phase 13 across every visible card (make_mesh(), two or more): the
    session per-block at B=1024 and with the default options at B=128, each
    block held to the unsharded engine on the first card under phase 4's
    rule; launches equal to shards x windows blocks; each card's kernel call
    bit-equal to the plain version on that card; realtime factor and
    process_block ms per engine. Returns the kernel launches."""
    from libzl_tpu_torch.ops import fetch_windows as fw
    from libzl_tpu_torch.parallel.sharding import make_mesh

    cards = make_mesh()
    k = cards.size
    check(k >= 2, f"mesh across cards needs two or more cards, has {k}")
    total = 0
    for mode, opts, B, n in (("per-block", dict(lookahead=0), SUPER_BLOCK, 8),
                             ("default", {}, LIVE_BLOCK, 40)):
        t0 = time.perf_counter()
        engines = mesh_engines(cards.devices[0], B, opts, {1: None, k: cards})
        for e in engines.values():
            e.fetch_dispatches = {"windows": 0, "gather": 0}
        sync_cards()
        fw.fetch_interp.launches = 0
        worst = drive_mesh(engines, n, f"mesh across {k} cards {mode} B={B}")
        sync_cards()
        launches = fw.fetch_interp.launches
        windows = {kk: e.fetch_dispatches["windows"]
                   for kk, e in engines.items()}
        check(sum(e.fetch_dispatches["gather"] for e in engines.values())
              == 0, "a block across cards fell back to the gather fetch")
        check(launches == sum(kk * w for kk, w in windows.items()),
              f"kernel launched {launches} times across cards, expected "
              f"shards x windows blocks of {windows}")
        for e in engines.values():
            check(e.stats()["spec_failures"] == 0,
                  f"speculative build failed across cards: "
                  f"{e.stats()['spec_last_failure']}")
        total += launches
        shard_v = (check_shard_kernels(engines[k], k)
                   if not engines[k]._lookahead else None)
        timing = {kk: time_mesh(e, 20 if B == SUPER_BLOCK else 96)
                  for kk, e in engines.items()}
        sync_cards()
        print(f"mesh across {k} cards ({', '.join(map(str, cards.devices))})"
              f" {mode} B={B} H={engines[1]._lookahead}: {n} blocks; max err "
              + ", ".join(f"{a} {v:.3e}" for a, v in worst[k].items())
              + f"; windows blocks {windows}, kernel launches {launches} "
              f"(= sum of k x blocks)"
              + (f"; each card's kernel bit-equal to plain at V={shard_v}"
                 if shard_v else "")
              + f" ({time.perf_counter() - t0:.1f} s)")
        print(f"[{card}] mesh across {k} cards {mode} B={B}: "
              + "; ".join(f"k={kk} realtime {t['rt']:.3f}x, process_block "
                          f"p50 {t['ms_p50']:.4f} ms"
                          for kk, t in timing.items())
              + " (chained blocks, one sync at the end)")
        del engines
    return total


@contextlib.contextmanager
def _phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="NAME=PATH.cu[,FLAG...]",
                    help="also time this source of the windows kernel in "
                         "phase 5, in turns with the port's (e.g. a parent "
                         "commit's copy); NAME is not kernel or plain")
    ap.add_argument("--mesh-cards-only", action="store_true",
                    help="run phases 1 and 2, then only phase 13 across "
                         "every visible card (needs two or more)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the GPU", file=sys.stderr)
        return 2
    device = "cuda"
    t_start = time.perf_counter()
    with _phase("1 environment"):
        card = phase_environment()
    with _phase("2 build"):
        phase_build()
        versions = dict(load_version(spec) for spec in opts.compare)
    if opts.mesh_cards_only:
        with _phase("13 mesh across cards"):
            launches = phase_mesh_cards(card)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"mesh_cards_launches": launches,
                          "count": torch.cuda.device_count()}))
        return 0
    check(not {"kernel", "plain"} & set(versions), "reserved version name")
    with _phase("3 kernel"):
        err = phase_kernel(device)
    with _phase("4 slice"):
        launches = phase_slice(device)
    with _phase("5 timing"):
        timing = phase_timing(device, card, versions)
    synthetic = f"{NUM_VOICES}x{SUPER_BLOCK}_synthetic"
    session = f"{NUM_VOICES}x{SUPER_BLOCK}_session"
    with _phase("6 default engine"):
        launches += phase_default_engine(device)
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_session_wavs(tmp)
        with _phase("7 bridge"):
            launches += phase_bridge(device, wavs, tmp)
        with _phase("8 pump"):
            launches += phase_pump(device, wavs, card)
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
    launches += mesh_launches
    print(f"timing: {json.dumps(timing)}")
    print(f"stretch: {json.dumps(stretch)}")
    print(f"mesh timing: {json.dumps(mesh_timing)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fetch_interp",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
