"""Groovebox demo: a four-bar drum-and-bass pattern through the full engine.

The port of examples/groovebox_demo.py: synthesized clips registered with
the sampler, a pattern sequenced through the timer-callback hook (the
schedule-ahead mechanism, lib/SyncTimer.cpp:397-401), per-channel strips,
metering, a recorded master WAV and a session checkpoint written with the
port's `save_session`.

    python -m libzl_tpu_torch.examples.groovebox_demo [out.wav]
        [--device cuda|cpu] [--bars N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from libzl_tpu_torch.constants import BEAT_SUBDIVISIONS
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.engine.render import RenderOutputs
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.models.session import save_session

SR = 48000


def synth_kick():
    t = np.arange(int(0.25 * SR)) / SR
    freq = 120 * np.exp(-t * 18) + 45
    body = np.sin(2 * np.pi * np.cumsum(freq) / SR)
    return (body * np.exp(-t * 14)).astype(np.float32)[:, None]


def synth_snare():
    rng = np.random.default_rng(7)
    t = np.arange(int(0.18 * SR)) / SR
    noise = rng.standard_normal(len(t)) * np.exp(-t * 28)
    tone = 0.4 * np.sin(2 * np.pi * 190 * t) * np.exp(-t * 22)
    return (0.6 * (noise * 0.5 + tone)).astype(np.float32)[:, None]


def synth_hat():
    rng = np.random.default_rng(3)
    t = np.arange(int(0.05 * SR)) / SR
    noise = rng.standard_normal(len(t)) * np.exp(-t * 70)
    return (0.25 * noise).astype(np.float32)[:, None]


def synth_bass():
    t = np.arange(int(0.5 * SR)) / SR
    wave = np.sign(np.sin(2 * np.pi * 55 * t)) * 0.25 + 0.2 * np.sin(
        2 * np.pi * 55 * t
    )
    env = np.minimum(t * 50, 1.0) * np.exp(-t * 3)
    return (wave * env * 0.8).astype(np.float32)[:, None]


PATTERN = {
    # sixteenth-step pattern per instrument (one bar, repeated)
    "kick":  [0, 4, 8, 10, 12],
    "snare": [4, 12],
    "hat":   list(range(0, 16, 2)),
    "bass":  [0, 6, 8, 14],
}
BASS_NOTES = [36, 36, 43, 41]  # per bar


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("output", nargs="?", default="groovebox_demo.wav")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--bars", type=int, default=4)
    args = ap.parse_args(argv)

    engine = AudioEngine(args.device, sample_rate=SR, num_voices=64)
    clips = {
        "kick": ClipAudioSource(engine, audio=AudioData(synth_kick(), SR)),
        "snare": ClipAudioSource(engine, audio=AudioData(synth_snare(), SR)),
        "hat": ClipAudioSource(engine, audio=AudioData(synth_hat(), SR)),
        "bass": ClipAudioSource(engine, audio=AudioData(synth_bass(), SR)),
    }
    channel = {"kick": 0, "snare": 1, "hat": 2, "bass": 3}
    clips["bass"].root_note = 36
    clips["bass"].adsr_release = 0.08
    clips["hat"].set_volume(-8.0)
    engine.set_strip(2, pan=0.3)     # hats slightly right
    engine.set_strip(3, dry=0.9)

    # the sequencer, scheduled through the timer-callback hook the way the
    # zynthbox sequencer inserts notes ahead of the playhead
    ticks_per_16th = BEAT_SUBDIVISIONS // 4

    def sequencer(tick: int) -> None:
        if tick % ticks_per_16th:
            return
        step16 = (tick // ticks_per_16th) % 16
        bar = (tick // (BEAT_SUBDIVISIONS * 4)) % args.bars
        for name, steps in PATTERN.items():
            if step16 in steps:
                cmd = ClipCommand.channel(clips[name].id, channel[name])
                cmd.midi_note = (
                    BASS_NOTES[bar % len(BASS_NOTES)] if name == "bass" else 60
                )
                cmd.start_playback = True
                cmd.change_volume = True
                cmd.volume = 1.0 if step16 % 4 == 0 else 0.7
                engine.schedule_clip_command(cmd, 0)

    engine.timer_callbacks.append(sequencer)
    engine.start_transport(bpm=120)

    engine.levels.set_record_global_playback(True)
    engine.levels.set_global_playback_filename_prefix(args.output)
    engine.levels.start_recording()

    seconds_per_bar = 2.0  # 4 beats at 120 bpm
    n_blocks = int(args.bars * seconds_per_bar * SR) // engine.block_frames
    # channel meters decay at the reference's 50 ms cadence, so their
    # session maxima are sampled live
    channel_max = [float("-inf")] * 4
    for i in range(n_blocks):
        res = engine.process_block()
        # recorders take every block, as host arrays; meters and positions
        # update at the 50 ms cadence (one device->host copy each)
        engine.levels.feed_recorders(RenderOutputs(
            *(t.cpu().numpy() for t in res.outputs)))
        if i % engine._levels_every == 0:
            engine.update_session(res, include_recorders=False)
            channel_max = [
                max(m, c) for m, c in zip(channel_max, engine.levels.channels)
            ]
        else:
            engine.accumulate_peaks(res)
    engine.levels.stop_recording()
    engine.drain_speculation()

    save_session(engine, args.output + ".zlsession")
    print(
        f"rendered {args.bars} bars on {engine.device} -> {args.output}\n"
        f"playback peak {engine.levels.playback_a_hold:.1f} dBFS (hold), "
        f"channel maxima {['%.0f' % c for c in channel_max]} dBFS\n"
        f"SLO: {engine.slo.missed_blocks}/{engine.slo.total_blocks} deadline "
        f"misses, dsp load {engine.dsp_load.load:.2f}\n"
        f"session checkpoint: {args.output}.zlsession"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
