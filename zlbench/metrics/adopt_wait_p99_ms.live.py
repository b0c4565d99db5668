"""adopt_wait_p99_ms.live: the lookahead's speculative chain (engine.engine),
p99 of the engine's `adopt_wait` span over the window (its profiler keeps a
span's last 2048 samples)."""


def read(run):
    s = run.spans.get("adopt_wait")
    return None if s is None else s["p99_ms"]
