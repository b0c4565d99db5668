"""render_ms.restretch: the clips' render worker (models.clip), ms a
render: the window's total of the `clip_render` span (the offline
re-render: WSOLA time-stretch, pitch's resample and stretch back, on the
worker's thread) over its count. None where the program has no such
span."""


def read(run):
    seconds, n = run.phases.get("clip_render", (0.0, 0))
    if not n:
        return None
    return seconds / n * 1e3
