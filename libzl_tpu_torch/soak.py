"""Randomized soak: thousands of blocks of adversarial command traffic.

The counterpart of the reference's tests/test_soak.py::_soak and, as a
command, of tools/soak_campaign.py. The traffic classes, their
probabilities and the invariants are the reference's, on the port's own
engine, clips and commands:

- traffic, one draw a block: note starts (every one with change_volume and
  a volume, some with a slice), note stops, BPM changes, sampler lane
  toggles, strip fuzz (direct and by timer command), scheduled notes and
  transport toggles; `extended` adds deferred stretch / pitch / gain
  re-renders (the clip's render worker), global-playback recording toggles
  and `save_session` checkpoints;
- invariants, every block: a finite master, positions of bounded voices
  inside their sounds, the BPM in [50, 200]; at the end, sound in more than
  a sixth of the blocks, every block counted by the SLO counter, and the
  process_block span recorded.

`Soak` holds one run and steps it a block at a time, so two runs with one
seed can be driven in lockstep (an unsharded and a sharded engine, say):
the draws depend only on the seed and on state the engines share.

    python -m libzl_tpu_torch.soak N [offset] [--device cuda|cpu]

runs N seeds from `offset`, each extended, per-block for 2500 blocks and
with the lookahead horizon for 500, as the reference's campaign runs its
numpy and jax backends, and reports each failing seed with its traceback.
The device defaults to cuda and is never picked for the caller.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
import traceback

import numpy as np

from .engine.commands import ClipCommand, Operation, TimerCommand
from .engine.engine import AudioEngine
from .io.wav import AudioData
from .models.clip import ClipAudioSource

SR = 48000


class SoakFailure(AssertionError):
    """An invariant of the soak broke."""


def _require(cond, msg: str) -> None:
    if not cond:
        raise SoakFailure(msg)


class Soak:
    """One soak run on its own engine: 24 voices, six sine clips of random
    length, transport at 120 BPM. `mesh` and `lookahead` go to the
    engine."""

    def __init__(self, device, seed: int, extended: bool = False,
                 tmp_dir=None, mesh=None, lookahead="auto"):
        if extended and tmp_dir is None:
            tmp_dir = tempfile.mkdtemp(prefix="libzl_soak_")
        self.extended = extended
        self.tmp_dir = tmp_dir
        self.rng = np.random.default_rng(seed)
        self.engine = AudioEngine(device, sample_rate=SR, num_voices=24,
                                  mesh=mesh, lookahead=lookahead)
        self.engine.start_transport(bpm=120)
        self.clips = []
        for i in range(6):
            frames = int(self.rng.integers(2000, 30000))
            t = np.arange(frames) / SR
            wave = (0.4 * np.sin(2 * np.pi * (110 + 70 * i) * t)).astype(
                np.float32)[:, None]
            self.clips.append(
                ClipAudioSource(self.engine, audio=AudioData(wave, SR)))
        self.blocks = 0
        self.audible_blocks = 0

    def traffic(self) -> None:
        """One block's random command (tests/test_soak.py:41-133)."""
        rng, engine = self.rng, self.engine
        roll = rng.random()
        clip = self.clips[int(rng.integers(0, len(self.clips)))]
        ch = int(rng.integers(-2, 10))
        if roll < 0.15:
            cmd = ClipCommand.channel(clip.id, ch)
            cmd.midi_note = int(rng.integers(30, 90))
            cmd.start_playback = True
            cmd.looping = bool(rng.integers(0, 2))
            cmd.change_volume = True
            cmd.volume = float(rng.uniform(0, 1))
            if rng.random() < 0.3:
                cmd.change_slice = True
                cmd.slice = int(rng.integers(0, 16))
            engine.schedule_clip_command(cmd, int(rng.integers(0, 8)))
        elif roll < 0.25:
            cmd = ClipCommand.channel(clip.id, ch)
            cmd.midi_note = int(rng.integers(30, 90))
            cmd.stop_playback = True
            engine.schedule_clip_command(cmd, int(rng.integers(0, 4)))
        elif roll < 0.28:
            engine.schedule_timer_command(
                TimerCommand(operation=Operation.SET_BPM,
                             parameter=int(rng.integers(40, 220))), 0)
        elif roll < 0.30:
            lane = int(rng.integers(-2, 10))
            engine.schedule_timer_command(
                TimerCommand(
                    operation=Operation.SAMPLER_CHANNEL_ENABLED_STATE,
                    parameter=lane, parameter2=int(rng.integers(0, 2)),
                ), 0)
        elif roll < 0.315:
            # strip fabric fuzz: direct API and timer-command paths
            ch = int(rng.integers(-1, 10))
            if rng.random() < 0.5:
                engine.set_strip(
                    ch,
                    dry=float(rng.uniform(0, 1)),
                    pan=float(rng.uniform(-1, 1)),
                    muted=float(rng.integers(0, 2)),
                )
            else:
                engine.schedule_timer_command(
                    TimerCommand(
                        operation=Operation.PASSTHROUGH_CLIENT,
                        parameter=ch,
                        parameter2=int(rng.integers(0, 5)),
                        parameter3=int(rng.integers(0, 101)),
                    ), 0)
        elif roll < 0.32:
            engine.schedule_note(
                int(rng.integers(30, 90)), int(rng.integers(0, 16)),
                velocity=int(rng.integers(1, 128)),
                duration=int(rng.integers(1, 200)),
                delay=int(rng.integers(0, 16)),
            )
        elif roll < 0.33 and engine.transport_running:
            engine.stop_transport()
        elif roll < 0.34 and not engine.transport_running:
            engine.start_transport()
        elif self.extended and roll < 0.355:
            # a scheduled stretch / pitch / gain change: the clip's deferred
            # re-render on its worker thread
            cmd = ClipCommand.channel(clip.id, ch)
            which = rng.random()
            if which < 0.4:
                cmd.change_speed = True
                cmd.speed_ratio = float(rng.uniform(0.5, 2.0))
            elif which < 0.8:
                cmd.change_pitch = True
                cmd.pitch_change = float(rng.uniform(-7, 7))
            else:
                cmd.change_gain_db = True
                cmd.gain_db = float(rng.uniform(-12, 3))
            engine.schedule_clip_command(cmd, int(rng.integers(0, 4)))
        elif self.extended and roll < 0.365:
            # recording toggles mid-flight (threaded WAV writers)
            levels = engine.levels
            if levels.is_recording:
                levels.stop_recording()
            else:
                levels.set_record_global_playback(True)
                levels.set_global_playback_filename_prefix(
                    f"{self.tmp_dir}/soak-")
                levels.start_recording()
        elif self.extended and roll < 0.37:
            from .models.session import save_session

            save_session(engine, f"{self.tmp_dir}/soak_session.json")

    def step(self):
        """Traffic, one block, the per-block invariants; returns the
        block's RenderOutputs."""
        b = self.blocks
        self.traffic()
        res = self.engine.process_block()
        out = res.outputs
        master = out.master.cpu().numpy()
        _require(np.isfinite(master).all(), f"non-finite output at block {b}")
        # liveness is measured before the strips (lane mixes): the strip
        # fuzz can mute the global playback strip for the rest of a run
        if float(out.lane_mix.abs().max()) > 1e-4:
            self.audible_blocks += 1
        # positions stay in range for positional / non-looping voices
        # (beat-quantized loops may play past the end of a short sound
        # until the musical wrap, SamplerSynthVoice.cpp:231); the bound is
        # max(length, stop): after a speed-up shrinks the playback render,
        # the stop position can exceed the buffer, and the voice plays the
        # reference's silence until its wrap or stop
        pool = self.engine.pool
        act = pool.active
        _require((pool.pos_int[act] >= 0).all(),
                 f"negative position at block {b}")
        bounded = act & ~(pool.looping & pool.beat_quantized)
        limit = (np.maximum(pool.length[bounded], pool.stop[bounded])
                 + pool.rate_int[bounded] + 2)
        _require((pool.pos_int[bounded] <= limit).all(),
                 f"position escaped its sound at block {b}")
        _require(50 <= self.engine.bpm <= 200,
                 f"bpm {self.engine.bpm} at block {b}")
        if b % 10 == 0:
            self.engine.update_session(res)
        self.blocks += 1
        return out

    def finish(self) -> dict:
        """Stop a recording in flight, wait for speculation, check the
        end-of-run invariants; returns the run's counters."""
        engine = self.engine
        if engine.levels.is_recording:
            engine.levels.stop_recording()
        engine.drain_speculation()
        n = self.blocks
        _require(self.audible_blocks > n // 6,
                 f"sound in {self.audible_blocks} of {n} blocks")
        _require(engine.slo.total_blocks == n,
                 f"SLO counted {engine.slo.total_blocks} of {n} blocks")
        _require(engine.profiler.summary()["process_block"]["count"] > 0,
                 "process_block span never recorded")
        stats = engine.stats()
        _require(stats["spec_failures"] == 0,
                 f"speculative build failed: {stats['spec_last_failure']}")
        return dict(blocks=n, audible_blocks=self.audible_blocks,
                    slo_by_kind=stats["slo_by_kind"],
                    spec_failures=stats["spec_failures"])


def soak(device, n_blocks: int, seed: int, extended: bool = False,
         tmp_dir=None, mesh=None, lookahead="auto") -> dict:
    """`n_blocks` of soak traffic on a fresh engine; raises SoakFailure on
    a broken invariant, else returns Soak.finish()'s counters."""
    run = Soak(device, seed, extended=extended, tmp_dir=tmp_dir, mesh=mesh,
               lookahead=lookahead)
    for _ in range(n_blocks):
        run.step()
    return run.finish()


# (label, lookahead, blocks) of each campaign seed: the reference campaign's
# numpy (per-block) and jax (lookahead horizon) runs
CAMPAIGN = (("per-block", 0, 2500), ("lookahead", "auto", 500))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_seeds", nargs="?", type=int, default=20)
    ap.add_argument("offset", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    failures = []
    t_start = time.time()
    for seed in range(args.offset, args.offset + args.n_seeds):
        for label, lookahead, blocks in CAMPAIGN:
            t0 = time.time()
            try:
                with tempfile.TemporaryDirectory() as td:
                    soak(args.device, blocks, seed + 10_000, extended=True,
                         tmp_dir=td, lookahead=lookahead)
                print(f"seed {seed} {label}: OK ({time.time() - t0:.1f}s)",
                      flush=True)
            except Exception:
                failures.append((seed, label))
                print(f"seed {seed} {label}: FAILED", flush=True)
                traceback.print_exc()
    total = args.n_seeds * len(CAMPAIGN)
    print(f"campaign done in {time.time() - t_start:.0f}s: "
          f"{total - len(failures)}/{total} passed", flush=True)
    if failures:
        print("FAILING SEEDS:", failures, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
