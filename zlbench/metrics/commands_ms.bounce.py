"""commands_ms.bounce: the engine's commands (engine.engine: the deferred
renders swapped in, the tick walk with its clip and timer commands, the
transport's ticks, the MIDI router, the sampler map and the watchdog), ms
a block: the window's total of the engine's `commands` span (the program's
totals, EngineRuntime.phase_stats) over its blocks."""


def read(run):
    if run.drive != "bounce":
        return None
    seconds, n = run.phases.get("commands", (0.0, 0))
    if not n:
        return None
    return seconds / run.blocks * 1e3
