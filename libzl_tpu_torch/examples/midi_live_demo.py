"""Live-MIDI demo: a (virtual) MIDI keyboard playing the sampler in real time.

The port of examples/midi_live_demo.py, the reference's "serve path"
(SURVEY.md §3.4): hardware MIDI in -> ZLRouter channel retargeting with
note stickiness -> sampler (lib/MidiRouter.cpp:506-566). A VirtualMidiPort
stands in for the hardware device (plug a real one in via
midi.devices.HardwareScanner / AlsaRawMidiPort on a host with libasound);
events feed the router at in-block frame offsets and the mapper converts
them into sample-accurate clip commands, pitch-tracked through the clip's
keyzone like SamplerSynthVoice::startNote (lib/SamplerSynthVoice.cpp:
115-116).

    python -m libzl_tpu_torch.examples.midi_live_demo out.wav
        [--device cuda|cpu] [--seconds 4]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData, write_wav
from libzl_tpu_torch.midi import messages as mm
from libzl_tpu_torch.midi.devices import VirtualMidiPort
from libzl_tpu_torch.midi.router import Destination
from libzl_tpu_torch.models.clip import ClipAudioSource

SR = 48000
BLOCK = 128


def synth_pluck():
    """A plucked-string-ish tone at root A3 (220 Hz, MIDI 57)."""
    t = np.arange(int(0.9 * SR)) / SR
    tone = (
        0.5 * np.sin(2 * np.pi * 220 * t)
        + 0.25 * np.sin(2 * np.pi * 440 * t + 0.3)
        + 0.12 * np.sin(2 * np.pi * 660 * t + 0.8)
    )
    return (tone * np.exp(-t * 5.0)).astype(np.float32)[:, None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    engine = AudioEngine(args.device, sample_rate=SR, block_frames=BLOCK,
                         num_voices=64)

    # the instrument: one clip, root note 57, pitch-tracked over two octaves
    clip = ClipAudioSource(engine, audio=AudioData(synth_pluck(), SR))
    clip.root_note = 57
    clip.keyzone_start, clip.keyzone_end = 45, 81
    clip.adsr_release = 0.12

    # sampler channel 0 receives hardware notes; mapper triggers the clip
    for ch in range(16):
        engine.router.set_channel_destination(ch, Destination.SAMPLER)
    engine.router.current_channel = 0
    engine.sampler_map.assign(0, clip)

    # the "hardware" keyboard
    keyboard = VirtualMidiPort("input-demo-keys", human_name="Demo Keys")
    engine.router.registry.add_input(keyboard)

    engine.start_transport(bpm=120)

    # a little arpeggio, timed in blocks (the events arrive between blocks
    # exactly like a poll of the hardware port between process callbacks)
    melody = [57, 60, 64, 69, 64, 60, 57, 52]
    events: dict[int, list[bytes]] = {}
    blocks_per_step = int(0.25 * SR) // BLOCK  # one note per 1/4 second
    for i, note in enumerate(melody):
        on_block = i * blocks_per_step
        off_block = on_block + blocks_per_step - 2
        events.setdefault(on_block, []).append(mm.note_on(note, 100, ch=0))
        events.setdefault(off_block, []).append(mm.note_off(note, ch=0))

    n_blocks = int(args.seconds * SR) // BLOCK
    out = []
    for b in range(n_blocks):
        for data in events.get(b, ()):
            keyboard.feed(data)
        res = engine.process_block()
        out.append(res.outputs.master)
    engine.drain_speculation()
    # one device->host copy for the whole take
    master = torch.cat(out).cpu().numpy()

    write_wav(args.output, master, SR)
    peak = float(np.abs(master).max())
    print(
        f"played {len(melody)} notes from '{keyboard.human_name}' through "
        f"the router->sampler path on {engine.device}: {args.seconds:.1f}s, "
        f"peak {peak:.3f} -> {args.output}"
    )
    return 0 if peak > 0.01 else 1


if __name__ == "__main__":
    sys.exit(main())
