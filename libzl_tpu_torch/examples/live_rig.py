"""Live rig: the recommended production boot sequence, executable.

The port of examples/live_rig.py, the embedding-host recipe for a live
groovebox, in order:

1. the reference's first step, a persistent XLA compile cache, has no
   counterpart: PyTorch compiles no graph, and the port's kernels build
   once into build/libzl_tpu_torch/ (named by a hash of their sources);
2. engine construction (bucketed dispatch is the default);
3. warmup: on the card, `start_pump` loads the kernels and renders every
   (bucket, kind) the session can dispatch BEFORE realtime, and pays
   the first device->host readback there, never inside the pump;
4. audio sink + MIDI wiring (hardware hot-plug where ALSA exists; a
   virtual port stands in everywhere else);
5. the realtime pump, then SLO/meter reporting.

The reference's equivalent is initJuce + JACK graph setup
(lib/libzl.cpp:358-410) followed by the clients' process callbacks.

    python -m libzl_tpu_torch.examples.live_rig [--device cuda|cpu]
        [--seconds 3] [--sink null|file:<path>|alsa[:dev]]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from libzl_tpu_torch.capi.bridge import EngineRuntime
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.io.sinks import make_sink
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.midi.devices import VirtualMidiPort
from libzl_tpu_torch.midi.router import Destination
from libzl_tpu_torch.models.clip import ClipAudioSource

SR = 48000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sink", default="null",
                    help='"alsa[:dev]", "file:<path>" or "null"')
    args = ap.parse_args(argv)

    # 2. engine + runtime (pump not started yet). Pool size per device:
    # the CPU renders a small pool; the card a bucketed 256-voice one
    t0 = time.perf_counter()
    runtime = EngineRuntime(
        sample_rate=SR, block_frames=128,
        num_voices=64 if args.device == "cpu" else 256,
        device=args.device, pipeline_depth=1,
    )
    engine = runtime.engine

    # 3. load the session's sounds; start_pump() then warms the card up
    # (every bucket shape + the first device->host readback)
    t = np.arange(SR // 2) / SR
    kick = (np.sin(2 * np.pi * 55 * t) * np.exp(-t * 18.0)).astype(
        np.float32)[: SR // 4, None]
    keys = (0.4 * np.sin(2 * np.pi * 220 * t)
            * np.exp(-t * 3.0)).astype(np.float32)[:, None]
    clip_kick = ClipAudioSource(engine, audio=AudioData(kick, SR))
    clip_keys = ClipAudioSource(engine, audio=AudioData(keys, SR))
    clip_keys.adsr_release = 0.08

    # 4. audio out + MIDI in. Hardware MIDI hot-plugs via the scanner when
    # libasound exists (engine.router.auto_discover); a virtual port is
    # the deterministic stand-in here.
    runtime.set_sink(make_sink(args.sink, SR))
    pad = VirtualMidiPort("Live Pad")
    engine.router.registry.add_input(pad)
    engine.router.set_channel_destination(0, Destination.SAMPLER)
    engine.sampler_map.assign(0, clip_keys)

    # 5. realtime: pump paced by the wall clock (or the ALSA sink's
    # hardware rate); sequence a kick and play pad notes while running
    runtime.start_pump()
    print(f"boot (engine+warmup+pump) on {engine.device}: "
          f"{time.perf_counter() - t0:.2f}s")
    runtime.run_locked(lambda: engine.start_transport(bpm=120))

    end = time.monotonic() + args.seconds
    beat = 0
    while time.monotonic() < end:
        cmd = ClipCommand.channel(clip_kick.id, 1)
        cmd.midi_note = 60
        cmd.start_playback = True
        cmd.change_volume = True
        cmd.volume = 1.0
        runtime.run_locked(lambda cmd=cmd: engine.schedule_clip_command(cmd,
                                                                         0))
        pad.feed(bytes([0x90, 57 + (beat % 4) * 5, 100]))
        time.sleep(0.5)
        pad.feed(bytes([0x80, 57 + (beat % 4) * 5, 0]))
        beat += 1

    runtime.stop_pump()
    runtime.set_sink(None)
    engine.drain_speculation()
    slo = engine.slo
    print(f"SLO: {slo.missed_blocks}/{slo.total_blocks} deadline misses, "
          f"dsp load {engine.dsp_load.load:.2f}, "
          f"playback peak {engine.levels.playback_a_hold:.1f} dBFS (hold)")
    wd = engine.watchdog
    print(f"watchdog: {wd.delivered}/{wd.scheduled} events delivered, "
          f"{wd.mismatches} mismatched blocks")
    if runtime.pump_error is not None:
        print(f"pump error: {runtime.pump_error!r}", file=sys.stderr)
        return 1
    if slo.total_blocks == 0:
        print("pump rendered no blocks", file=sys.stderr)
        return 1
    print("live rig OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
