"""notes_ms.seq: the played notes' path (engine.engine commands), ms a
block: the window's total of the engine's `notes` span (the MIDI fabric of a
block whose scheduled MIDI carries a note: router, transport passthrough,
sampler map, allocator; the program's totals, EngineRuntime.phase_stats)
over the window's blocks. None where the program has no such span."""


def read(run):
    seconds, n = run.phases.get("notes", (0.0, 0))
    if not n:
        return None
    return seconds / run.blocks * 1e3
