"""notes_p99_ms.seq: the played notes' path (engine.engine commands), p99 of
the engine's `notes` span over the window's note blocks (its profiler keeps
a span's last 2048 samples). None where the program has no such span."""


def read(run):
    s = run.spans.get("notes")
    return None if s is None else s["p99_ms"]
