"""dispatch_ms.bounce: the render graphs' dispatch (engine.graphs), p50 of
the engine's `dispatch` span over the window (its last 2048 samples)."""


def read(run):
    if run.drive != "bounce":
        return None
    s = run.spans.get("dispatch")
    return None if s is None else s["p50_ms"]
