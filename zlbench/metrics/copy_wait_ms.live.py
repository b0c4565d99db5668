"""copy_wait_ms.live: the runtime's per-block delivery (capi.bridge), ms a
block the host waits for its device->host copy: the window's copy_wait
seconds (EngineRuntime.phase_stats) over its blocks."""


def read(run):
    seconds, n = run.phases.get("copy_wait", (0.0, 0))
    if not n:
        return None
    return seconds / run.blocks * 1e3
