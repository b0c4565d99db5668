"""Multi-device demo: a large voice pool sharded over a mesh of devices.

The port of examples/multichip_demo.py. One process drives every device of
the mesh: each shard renders its voices on its own device (the windows
kernel on a card) and the lane mixes are summed on the first. By default
the mesh is every visible card; `--shards N` repeats the one device N
times instead, which exercises the same split, per-shard render and
reduction on a single card or on the CPU.

    python -m libzl_tpu_torch.examples.multichip_demo [out.wav]
        [--device cuda|cpu] [--shards N] [--voices V] [--seconds S]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData, write_wav
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.parallel.sharding import make_mesh

SR = 48000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("output", nargs="?", default="multichip_demo.wav")
    ap.add_argument("--device", default="cuda",
                    help="the device that --shards repeats: cuda, cuda:N "
                         "or cpu")
    ap.add_argument("--shards", type=int, default=0,
                    help="repeat --device this many times (default: every "
                         "visible card; required with --device cpu)")
    ap.add_argument("--voices", type=int, default=4096)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    if args.shards:
        mesh = make_mesh(devices=[args.device] * args.shards)
    else:
        mesh = make_mesh()
    print(f"mesh: {mesh.size} shards on "
          f"{', '.join(str(d) for d in mesh.distinct())}")
    engine = AudioEngine(mesh.devices[0], sample_rate=SR, block_frames=1024,
                         num_voices=args.voices, mesh=mesh)
    engine.start_transport(bpm=128)

    # a spread of detuned tones across all 10 sampler channels
    rng = np.random.default_rng(7)
    clips = []
    for i in range(10):
        t = np.arange(SR // 2) / SR
        f = 110.0 * 2 ** (i / 5.0)
        wave = (0.2 * np.sin(2 * np.pi * f * t)).astype(np.float32)[:, None]
        clips.append(ClipAudioSource(engine, audio=AudioData(wave, SR)))

    # a dense looped chord cloud: 32 voices per channel at distinct pitches
    # (each (clip, channel, note) triple claims its own voice)
    for i, clip in enumerate(clips):
        for v in range(32):
            cmd = ClipCommand.channel(clip.id, i)
            cmd.midi_note = 36 + v
            cmd.change_volume = True
            cmd.volume = 0.08
            cmd.looping = True
            cmd.start_playback = True
            engine.schedule_clip_command(cmd, int(rng.integers(0, 24)))
        # plus a short percussive burst through the note scheduler
        for note in (48, 52, 55, 60):
            engine.schedule_note(
                note, midi_channel=i, velocity=100,
                duration=int(rng.integers(40, 90)),
                delay=int(rng.integers(0, 48)),
            )

    blocks = []
    for _ in range(int(args.seconds * SR) // engine.block_frames):
        res = engine.process_block()
        blocks.append(res.outputs.master.cpu().numpy())
    engine.drain_speculation()
    master = np.concatenate(blocks, axis=0)
    write_wav(args.output, master, SR)
    print(f"rendered {master.shape[0] / SR:.1f}s with "
          f"{int(engine.pool.active.sum())} live voices sharded over "
          f"{mesh.size} shards (fetch {engine.fetch}), peak "
          f"{np.abs(master).max():.3f} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
