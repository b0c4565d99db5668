#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (libzl_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero:

1. environment — torch/CUDA/nvcc versions, the card's name and power limit;
   no CUDA device means exit 2 (this script never runs on the CPU);
2. build       — nvcc builds libzl_tpu_torch/csrc/*.cu for sm_90a;
3. kernel      — the windows fetch kernel against its plain PyTorch version
   on the card, at (V, B) = (1024, 128) and (1024, 1024), f32 and int16
   banks, with engine-like and hostile positions (atol 2e-6 / 3e-6,
   out-of-range lanes exactly 0);
4. slice       — the north-star session (1024 voices, 64 looped clips at
   48 kHz, 120 BPM; the port of bench.py's build_session) through
   AudioEngine on "cuda" (fetch resolves to the windows kernel) and on
   "cpu" (the plain gather path): 8 superblocks (B=1024), then 16 live
   blocks (B=128), every block compared (voice_peaks atol 2e-6; lane_mix
   and master rtol 1e-5, atol 2e-6 x voices in the densest lane); the
   kernel's launch count must equal the dispatched blocks, and no block
   may fall back to gather;
5. timing      — superblock realtime factor, live-block ms, host program
   build and dispatch ms, a torch.profiler pass per geometry (device ms and
   kernels per block, device busy share), kernel and plain fetch ms (p50
   over CUDA events: device time, and call time with the host's launch
   latency).

The line before the last holds the kernel record as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

NUM_VOICES = 1024
NUM_CLIPS = 64
SAMPLE_RATE = 48000
SUPER_BLOCK = 1024
LIVE_BLOCK = 128
SLICE_SUPER_BLOCKS = 8
SLICE_LIVE_BLOCKS = 16
BANK_FRAMES = 1 << 22      # SoundBank's default capacity

FETCH_ATOL = 2e-6          # tests/test_fetch_windows.py:54
HOSTILE_ATOL = 3e-6        # tests/test_fetch_windows.py:294
PEAK_ATOL = 2e-6
MIX_RTOL = 1e-5
MIX_ATOL_PER_VOICE = 2e-6

KERNEL_SOURCE = "libzl_tpu_torch/csrc/fetch_interp.cu"
KERNEL_REPLACES = "libzl_tpu/ops/fetch_pallas.py:450"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def build_session(engine, num_voices: int = NUM_VOICES,
                  num_clips: int = NUM_CLIPS):
    """bench.py's build_session on a given engine: `num_clips` two-partial
    sine clips of 0.4-2 s and one looped ClipCommand per voice across 10
    channels, all drawn from seed 0, transport started at 120 BPM."""
    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    sr = engine.sample_rate
    engine.start_transport(bpm=120)
    rng = np.random.default_rng(0)
    clips = []
    for i in range(num_clips):
        seconds = float(rng.uniform(0.4, 2.0))
        t = np.arange(int(sr * seconds)) / sr
        freq = 110.0 * (2.0 ** (i % 24 / 12.0))
        wave = (
            0.25 * np.sin(2 * np.pi * freq * t)
            + 0.1 * np.sin(2 * np.pi * 2 * freq * t)
        ).astype(np.float32)[:, None]
        clips.append(ClipAudioSource(engine, audio=AudioData(wave, sr)))
    for v in range(num_voices):
        clip = clips[v % num_clips]
        cmd = ClipCommand.channel(clip.id, v % 10)
        # distinct notes per (clip, channel) pair so no commands coalesce
        cmd.midi_note = 48 + (v // 320) * 5 + int(rng.integers(0, 5))
        cmd.change_volume = True
        cmd.volume = float(rng.uniform(0.3, 1.0))
        cmd.looping = True
        cmd.start_playback = True
        engine.schedule_clip_command(cmd, 0)
    return clips


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
                  device):
    """Random bank, windows and window-relative positions. Engine-like
    draws keep each voice's positions inside its regions; hostile draws
    add negative, past-the-end and region-edge positions (p = region-1
    reads region B's first sample at tap p+1; 2*region-2 is the last valid
    position, 2*region-1 the first invalid one)."""
    from libzl_tpu_torch.ops.fetch_windows import region_rows

    region = region_rows(B)
    sound = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    if dtype == torch.int16:
        sound = np.clip(np.round(sound * np.float32(32767.0)),
                        -32768, 32767).astype(np.int16)
    max_blk = (n - region) // 512
    win_a = rng.integers(0, max_blk, V).astype(np.int32)
    win_b = rng.integers(0, max_blk, V).astype(np.int32)
    span = int(4.0 * B) + 2
    base_a = rng.integers(0, region - span, V)[:, None]
    base_b = region + rng.integers(0, region - span, V)[:, None]
    step = rng.integers(0, 5, (V, 1))  # ratio 0..4 samples per frame
    frames = np.arange(B)[None, :]
    seg = rng.integers(0, 2, (V, B))
    pos = np.where(seg == 0, base_a + frames * step, base_b + frames * step)
    if hostile:
        kind = rng.integers(0, 6, (V, B))
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
                print(f"kernel V={V} B={B} {str(dtype)[6:]} "
                      f"{'hostile' if hostile else 'engine '}: max_abs_err "
                      f"{err:.3e} (atol {tol:g}), out-of-range lanes "
                      f"{int(out_of_range.sum())} max |out| {oor_max}")
                check(bool(torch.isfinite(got).all()), "non-finite output")
                check(err <= tol, f"kernel disagrees with plain: {err}")
                check(oor_max == 0.0, "out-of-range lane is not exactly 0")
                worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


def _densest_lane(engine) -> int:
    act = engine.pool.active
    return int(np.bincount(engine.pool.lane[act], minlength=12).max()) \
        if act.any() else 0


def _compare_blocks(gpu, cpu, n_blocks: int, label: str) -> dict:
    worst = {"master": 0.0, "lane_mix": 0.0, "voice_peaks": 0.0}
    for i in range(n_blocks):
        before = _densest_lane(gpu)
        og = gpu.process_block().outputs
        oc = cpu.process_block().outputs
        mix_atol = MIX_ATOL_PER_VOICE * max(before, _densest_lane(gpu), 1)
        for name, atol, rtol in (("voice_peaks", PEAK_ATOL, 0.0),
                                 ("lane_mix", mix_atol, MIX_RTOL),
                                 ("master", mix_atol, MIX_RTOL)):
            a = getattr(og, name).cpu().numpy()
            b = getattr(oc, name).numpy()
            check(a.shape == b.shape and np.isfinite(a).all(),
                  f"{label} block {i} {name}: shape/finite")
            err = np.abs(a - b)
            worst[name] = max(worst[name], float(err.max()))
            bad = err > atol + rtol * np.abs(b)
            check(not bad.any(),
                  f"{label} block {i} {name}: max err {err.max():.3e} "
                  f"(atol {atol:.1e}, rtol {rtol:g})")
        check(float(np.abs(og.master.cpu().numpy()).max()) > 0,
              f"{label} block {i}: silent master")
    return worst


def phase_slice(device) -> int:
    from libzl_tpu_torch.engine.engine import AudioEngine
    from libzl_tpu_torch.ops import fetch_windows as fw

    pairs = []
    for B, n in ((SUPER_BLOCK, SLICE_SUPER_BLOCKS),
                 (LIVE_BLOCK, SLICE_LIVE_BLOCKS)):
        gpu = AudioEngine(device, sample_rate=SAMPLE_RATE, block_frames=B,
                          num_voices=NUM_VOICES)
        cpu = AudioEngine("cpu", sample_rate=SAMPLE_RATE, block_frames=B,
                          num_voices=NUM_VOICES)
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


def _events_ms(fn, iters: int, primed: bool) -> list:
    """Per-call ms over CUDA events, one event pair per call, with the 50 MB
    L2 flushed before each call (the render's other tensors evict the
    bank's windows between fetches). `primed` queues a ~2.5 ms device spin
    after the flush, so the host enqueues the call (the plain version's
    ~20 ops included) while the card is busy and the pair brackets device
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
          f"unprofiled process_block p50 ({block_ms:.4f} ms)")


def phase_timing(device, card: str) -> dict:
    from libzl_tpu_torch.engine.engine import AudioEngine
    from libzl_tpu_torch.ops import fetch_windows as fw

    res = {}
    # superblock realtime factor: blocks chained, one sync at the end
    eng = AudioEngine(device, sample_rate=SAMPLE_RATE,
                      block_frames=SUPER_BLOCK, num_voices=NUM_VOICES)
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
    print(f"[{card}] superblock realtime factor {res['rt_superblock']:.3f}x "
          f"(rounds {', '.join(f'{r:.3f}' for r in rounds)}; 1024 voices, "
          f"64 clips, B=1024, 48 kHz)")

    # live blocks: chained (no per-block sync), one sync at the end
    live = AudioEngine(device, sample_rate=SAMPLE_RATE,
                       block_frames=LIVE_BLOCK, num_voices=NUM_VOICES)
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

    # fetch kernel vs plain version at the main path's shapes, in turns
    rng = np.random.default_rng(99)
    for V, B in ((NUM_VOICES, LIVE_BLOCK), (NUM_VOICES, SUPER_BLOCK)):
        args = kernel_inputs(rng, V, B, BANK_FRAMES, torch.float32, False,
                             device)
        fns = {"kernel": lambda: fw.fetch_interp(*args),
               "plain": lambda: fw.fetch_interp_plain(*args)}
        for f in fns.values():
            for _ in range(5):
                f()
        for primed, tag in ((True, ""), (False, "call_")):
            samples = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                samples[name] += _events_ms(fns[name], 25, primed)
            k = float(np.median(samples["kernel"]))
            p = float(np.median(samples["plain"]))
            res[f"kernel_{tag}ms_{V}x{B}"] = k
            res[f"plain_{tag}ms_{V}x{B}"] = p
            mbytes = V * B * 24 / 1e6
            what = ("device time" if primed
                    else "call time incl. host launch latency")
            print(f"[{card}] fetch V={V} B={B} {what}: kernel {k:.4f} ms, "
                  f"plain {p:.4f} ms (p50 of 50 CUDA-event timings each, in "
                  f"turns; ~{mbytes:.1f} MB -> kernel "
                  f"{mbytes / 1e3 / (k / 1e3):.1f} GB/s)")
    torch.cuda.synchronize()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the GPU", file=sys.stderr)
        return 2
    device = "cuda"
    t_start = time.perf_counter()
    card = phase_environment()
    phase_build()
    err = phase_kernel(device)
    launches = phase_slice(device)
    timing = phase_timing(device, card)
    print(f"timing: {json.dumps(timing)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fetch_interp",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": timing[f"kernel_ms_{NUM_VOICES}x{SUPER_BLOCK}"],
        "plain_ms": timing[f"plain_ms_{NUM_VOICES}x{SUPER_BLOCK}"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
