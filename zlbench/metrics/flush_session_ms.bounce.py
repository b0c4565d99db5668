"""flush_session_ms.bounce: the bounce drain's session updates
(capi.bridge: update_session of each meter-cadence block it delivers), ms
a block: the window's total of the runtime's `flush_session` span (the
program's totals, EngineRuntime.phase_stats) over its blocks."""


def read(run):
    if run.drive != "bounce":
        return None
    seconds, n = run.phases.get("flush_session", (0.0, 0))
    if not n:
        return None
    return seconds / run.blocks * 1e3
