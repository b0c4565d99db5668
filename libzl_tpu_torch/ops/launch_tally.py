"""The kernels' launch counts, and launches recorded into a CUDA graph.

Each kernel wrapper (ops/fetch_windows.fetch_interp, ops/mixdown.lane_mixdown,
ops/voice_render.voice_prep and voice_post, ops/finish.finish) is registered
under its kernel's name (`register`, which returns it as a `Counted`) and
calls `count` where it launches its kernel; the count is the wrapper's
`launches` attribute. A call made while the calling thread captures a render
graph (engine/graphs.py) does not launch anything: it adds a node to the
graph. Such a call goes into the capture's tally. Each captured graph keeps
its tally with its replays (`Replays`), which a replay counts up without a
lock, and a count, when read, adds every live graph's tally times its
replays, so it still says how often each kernel ran. A graph that will not
replay again (`retire`, or collected) folds its replays into the counts.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import weakref

_local = threading.local()
_wrappers = {}
# the live graphs' Replays
_replayed = set()
# Replays of graphs that will not replay again, to fold into the counts at
# the next read: appended without the lock (a finalizer may append)
_retired = []
# the engine thread and the speculative horizon's dispatch thread both
# launch kernels: the read-modify-write of a count takes the lock
_lock = threading.Lock()


class Replays:
    """A captured graph's launches by kernel name (`launches`, filled while
    it captures) and its replays (`n`, counted up by the thread that holds
    the graph's lock). Retired when `owner` (the graph) is collected."""

    __slots__ = ("launches", "n")

    def __init__(self, launches: dict, owner):
        self.launches = launches
        self.n = 0
        with _lock:
            _replayed.add(self)
        weakref.finalize(owner, _retired.append, self)


def retire(replays: Replays) -> None:
    """`replays`' graph will not replay again: its launches fold into the
    counts."""
    _retired.append(replays)


def _fold() -> None:
    """Fold the retired graphs' launches into the counts (the lock held)."""
    while _retired:
        r = _retired.pop()
        if r in _replayed:
            _replayed.discard(r)
            for name, k in r.launches.items():
                _wrappers[name]._counted += r.n * k


def _replays_of(name: str) -> int:
    """The launches of `name` that live graphs' replays made (the lock
    held, retired graphs folded)."""
    return sum(r.n * r.launches.get(name, 0) for r in _replayed)


class Counted:
    """A kernel wrapper and its launch count: `launches` is the launches
    counted (`count`, `add`) plus those its kernel made in graph replays;
    setting it sets that sum. `register` makes each its own subclass whose
    `__call__` is the wrapped function, so a call goes straight to it."""

    def __init__(self, name: str, fn):
        functools.update_wrapper(self, fn)
        self._name = name
        self._counted = 0

    @property
    def launches(self) -> int:
        with _lock:
            _fold()
            return self._counted + _replays_of(self._name)

    @launches.setter
    def launches(self, n: int) -> None:
        with _lock:
            _fold()
            self._counted = n - _replays_of(self._name)


def register(name: str, fn) -> Counted:
    """`fn` as the wrapper of kernel `name`, its launches counted from 0."""
    cls = type(f"Counted_{name}", (Counted,),
               {"__call__": staticmethod(fn)})
    wrapper = cls(name, fn)
    _wrappers[name] = wrapper
    return wrapper


def counts() -> dict:
    """Every registered kernel's launch count, by name."""
    with _lock:
        _fold()
        return {name: w._counted + _replays_of(name)
                for name, w in _wrappers.items()}


def reset() -> None:
    """Zero every registered kernel's launch count."""
    with _lock:
        _fold()
        for name, w in _wrappers.items():
            w._counted = -_replays_of(name)


def add(tally: dict) -> None:
    """Add `tally` ({name: launches}) to the counts."""
    with _lock:
        for name, n in tally.items():
            _wrappers[name]._counted += n


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
