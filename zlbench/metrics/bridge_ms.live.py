"""bridge_ms.live: the runtime's per-block delivery (capi.bridge), ms a
block: the window's total of its `step` spans less the engine's
`process_block` inside them (the staging copy, the copy wait, the unpack,
the sink write, the session update, the timer callbacks and the lock
between), over
its blocks (the program's totals, EngineRuntime.phase_stats)."""


def read(run):
    if run.drive != "live":
        return None
    step, n = run.phases.get("step", (0.0, 0))
    block, m = run.phases.get("process_block", (0.0, 0))
    if not n or not m:
        return None
    return (step - block) / run.blocks * 1e3
