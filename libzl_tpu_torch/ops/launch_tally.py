"""The kernels' launch counts, and launches recorded into a CUDA graph.

Each kernel wrapper (ops/fetch_windows.fetch_interp, ops/mixdown.lane_mixdown,
ops/voice_render.voice_prep and voice_post, ops/finish.finish) registers
under its kernel's name and calls `count` where it launches its kernel; the
count is the wrapper's `launches` attribute. A call made while the calling
thread captures a render graph (engine/graphs.py) does not launch anything:
it adds a node to the graph. Such a call goes into the capture's tally, and
the graph adds the tally to the counts each time it replays (`add`), so a
count still says how often each kernel ran.
"""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()
_wrappers = {}
# the engine thread and the speculative horizon's dispatch thread both
# launch kernels: the read-modify-write of a count takes the lock
_lock = threading.Lock()


def register(name: str, wrapper) -> None:
    """Count `name`'s launches on `wrapper.launches`, from 0."""
    wrapper.launches = 0
    _wrappers[name] = wrapper


def counts() -> dict:
    """Every registered kernel's launch count, by name."""
    with _lock:
        return {name: w.launches for name, w in _wrappers.items()}


def reset() -> None:
    """Zero every registered kernel's launch count."""
    with _lock:
        for w in _wrappers.values():
            w.launches = 0


def add(tally: dict) -> None:
    """Add `tally` ({name: launches}: a replayed graph's recorded ones) to
    the counts."""
    with _lock:
        for name, n in tally.items():
            _wrappers[name].launches += n


def count(name: str) -> None:
    """One launch of `name`: tallied when the calling thread is recording,
    counted otherwise."""
    if not recorded(name):
        add({name: 1})


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
