"""Kernel launches recorded into a CUDA graph instead of launched.

Each kernel wrapper (ops/fetch_windows.fetch_interp, ops/mixdown.lane_mixdown)
counts its launches. A call made while the calling thread captures a render
graph (engine/graphs.py) does not launch anything: it adds a node to the
graph. Such a call goes into the capture's tally, and the graph adds the
tally to the wrappers' counts each time it replays, so a count still says
how often each kernel ran.
"""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()


@contextlib.contextmanager
def recording():
    """Tally, by kernel name, the launches the calling thread makes inside
    the block instead of counting them (a Counter, yielded)."""
    tally = collections.Counter()
    outer = getattr(_local, "tally", None)
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = outer


def recorded(name: str) -> bool:
    """True, and one launch of `name` tallied, when the calling thread is
    recording; False when the caller should count the launch itself."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        return False
    tally[name] += 1
    return True
