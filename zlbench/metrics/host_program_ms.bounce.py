"""host_program_ms.bounce: the native host core (engine.hostcore), p50 of
the engine's `host_program` span over the window (its last 2048 samples)."""


def read(run):
    s = run.spans.get("host_program")
    return None if s is None else s["p50_ms"]
