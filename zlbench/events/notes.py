"""notes: live notes over the loops, as the step sequencer or a hardware
MIDI input sends them (`send_note_immediately` right before a block).

Parameters (the mix's `notes`): `rate_hz`, `pitch`, `velocity`, `gate_ms`,
read by `session.note_stream`, the one generator of the stream. Each note
plays on its channel's clip (`session.keys_clip`) at the first tick of the
musical clock at or after its block's first frame, so the benchmark
decides its effect block before the window and keeps it: the blocks where
notes start or are released. A block's note-offs are sent before its
note-ons, each in stream order.
"""

from __future__ import annotations

from zlbench import harness, reference, session


def plan(params: dict, w) -> harness.Plan:
    notes = session.note_stream(params, w.seconds, w.period_s, w.seed)
    n = w.blocks
    keyed = []
    for order, note in enumerate(notes):
        if note.off_block < n:
            keyed.append((note.off_block, 0, order, False, note))
        if note.on_block < n:
            keyed.append((note.on_block, 1, order, True, note))
    keyed.sort(key=lambda x: x[:3])
    cfg = w.cell.config
    B = int(cfg["block_frames"])
    spt = 60.0 / (float(cfg["bpm"]) * 96) * float(cfg["sample_rate"])
    clips = len(w.session.clips)
    events = []
    for blk, _, _, on, note in keyed:
        b, frame, tick = reference.tick_of_send(w.first + blk, B, spt)
        clip = session.keys_clip(note.channel, clips)
        if on:
            events.append(reference.Start(b, frame, tick, clip, note.channel,
                                          note.pitch, note.velocity / 127.0,
                                          False))
        else:
            events.append(reference.Stop(b, frame, clip, note.channel,
                                         note.pitch))
    return harness.Plan([(blk, (on, note)) for blk, _, _, on, note in keyed],
                        {e.block for e in events},
                        {"notes": notes, "events": events})


def send(command: tuple, w) -> None:
    on, note = command
    w.session.rt.engine.send_note_immediately(
        note.pitch, note.channel, on, note.velocity if on else 64)


def read(plan: harness.Plan, w) -> None:
    """The benchmark decided each note's effect block: nothing to read."""


def events(plan: harness.Plan, w) -> list:
    return plan.state["events"]
