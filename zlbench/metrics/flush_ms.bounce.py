"""flush_ms.bounce: the runtime's bounce drain (capi.bridge), ms a block:
the window's flush_plan + flush_concat + flush_sync + flush_deliver seconds
(EngineRuntime.phase_stats, cumulative) over its blocks."""

PHASES = ("flush_plan", "flush_concat", "flush_sync", "flush_deliver")


def read(run):
    seconds = sum(run.phases.get(p, (0.0, 0))[0] for p in PHASES)
    if not any(run.phases.get(p, (0.0, 0))[1] for p in PHASES):
        return None
    return seconds / run.blocks * 1e3
