"""Per-block timing, SLO accounting, xrun-analog detection, device tracing.

The counterpart of libzl_tpu/utils/profiling.py. SloCounter, DspLoad and
EventWatchdog are the reference's code, copied verbatim; `device_trace`
wraps torch.profiler where the reference's wraps jax.profiler.

BlockProfiler is the reference's span timer (each span's last `window`
samples, `summary()`), extended into the port's one span record:

- `totals()`: each span's count, total and longest over the profiler's
  life, always kept;
- a timeline, off by default and shared by every profiler in the process
  (`start_recording`, `stop_recording`, `export`): while it records, each
  span is kept with its start and end on the host's wall clock (the clock
  torch.profiler's device events are stamped on), its thread, the block it
  works for and the span that caused it, and each of Python's collections
  is a span "gc" on the thread it ran on.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..device import resolve_device

_now_ns = time.perf_counter_ns

# span ids: process-wide and never reused, so a parent id names one span
# even across recordings
_ticket = itertools.count()
# the calling thread's stack of open recorded spans, (id, block), and its
# label
_tls = threading.local()
# the recording under way (a _Recording), or None: the one flag a span
# tests
_rec = None
# the last recording started, exported after it stopped too
_last = None

# thread-name prefix -> the label a span's thread is exported under; any
# other thread is the engine's caller
THREAD_LABELS = (("libzl-spec-sim", "spec-sim"),
                 ("libzl-spec-dispatch", "spec-dispatch"),
                 ("libzl-pump", "pump"),
                 ("libzl-render", "render"))


def thread_label() -> str:
    """The calling thread's label in the record, by the thread's name:
    "spec-sim", "spec-dispatch", "pump" (the runtime's threads), "render"
    (the clips' render worker) or "engine"."""
    name = threading.current_thread().name
    for prefix, label in THREAD_LABELS:
        if name.startswith(prefix):
            return label
    return "engine"


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.label = thread_label()
        _tls.stack = []
        return _tls.stack


class _Recording:
    """One recording: a buffer of `capacity` slots, slot i holding span id
    `base + i`, the ids of the spans past it (`over`), and the
    (perf_counter_ns, time_ns) pair its stamps are converted by."""

    __slots__ = ("buf", "base", "capacity", "over", "pc0", "wall0", "end",
                 "gc_t0")

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 0)
        self.buf = [None] * self.capacity
        a = _now_ns()
        self.wall0 = time.time_ns()
        b = _now_ns()
        self.pc0 = (a + b) // 2
        self.base = next(_ticket) + 1
        self.over = []        # list.append: one atomic step from any thread
        self.end = None       # the first id past the recording, once stopped
        self.gc_t0 = 0


def start_recording(capacity: int) -> None:
    """Start the timeline: the next `capacity` spans to open, in every
    thread, are kept; those past it are counted in `export()`'s
    "dropped". Replaces any recording under way."""
    global _rec, _last
    stop_recording()
    _last = _rec = _Recording(capacity)
    gc.callbacks.append(_gc_hook)


def stop_recording() -> None:
    """Stop the timeline; what it kept stays exportable."""
    global _rec
    rec, _rec = _rec, None
    if rec is not None:
        rec.end = next(_ticket)
        with contextlib.suppress(ValueError):
            gc.callbacks.remove(_gc_hook)


def recording() -> bool:
    return _rec is not None


def mark() -> int:
    """An id below every span opened from now on: `export(since=mark())`
    reads only those."""
    return next(_ticket)


def current():
    """The id of the calling thread's innermost open span while the
    timeline records, else None: what a worker's span names as its cause."""
    if _rec is None:
        return None
    stack = _stack()
    return stack[-1][0] if stack else None


def export(since: int = None) -> dict:
    """The last recording's spans, closed ones only, in id order (the order
    they opened): each a dict of `id`, `name`, `start_ns` and `end_ns`
    (time.time_ns()'s clock), `thread` (thread_label), `block` (the block
    it works for, or None), `parent` (the id of the span that caused it,
    or None) and, for a collection, `generation`. `since`: only spans of
    that id on. Also `dropped` (spans past the capacity) and `next` (the
    `since` that reads on from here)."""
    rec = _last
    if rec is None:
        return {"spans": [], "dropped": 0, "next": since or 0}
    hi = rec.end if rec.end is not None else next(_ticket)
    lo = max((since or rec.base) - rec.base, 0)
    shift = rec.wall0 - rec.pc0
    spans = []
    for r in rec.buf[lo:hi - rec.base]:
        if r is None:
            continue
        i, name, t0, t1, thread, block, parent, generation = r
        d = {"id": i, "name": name, "start_ns": t0 + shift,
             "end_ns": t1 + shift, "thread": thread, "block": block,
             "parent": parent}
        if generation is not None:
            d["generation"] = generation
        spans.append(d)
    return {"spans": spans, "dropped": len(rec.over), "next": hi}


def _keep(rec: _Recording, i: int, name: str, t0: int, t1: int, block,
          parent, generation=None) -> None:
    j = i - rec.base
    if j < rec.capacity:
        rec.buf[j] = (i, name, t0, t1, _tls.label, block, parent, generation)
    else:
        rec.over.append(i)


def _gc_hook(phase: str, info: dict) -> None:
    """gc.callbacks, while the timeline records: each collection a span
    "gc" on the thread it ran on, inside that thread's innermost span."""
    rec = _rec
    if rec is None:
        return
    if phase == "start":
        rec.gc_t0 = _now_ns()
        return
    t1 = _now_ns()
    stack = _stack()
    top = stack[-1] if stack else (None, None)
    _keep(rec, next(_ticket), "gc", rec.gc_t0, t1, top[1], top[0],
          info.get("generation"))


class _Stat:
    """One span name's totals over its profiler's life (count, total ns,
    longest ns) and its last `window` durations in seconds."""

    __slots__ = ("n", "total", "top", "window")

    def __init__(self, window: int):
        self.n = self.total = self.top = 0
        self.window = deque(maxlen=window)


class _Span:
    """One timed span (BlockProfiler.span) while the timeline is off: its
    duration goes into its name's totals and window, nothing else."""

    __slots__ = ("prof", "name", "block", "parent", "t0", "ns")
    # a recorded span's id (_RecSpan)
    id = None

    def __enter__(self):
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        ns = self.ns = _now_ns() - self.t0
        prof = self.prof
        st = prof._stats.get(self.name)
        if st is None:
            st = prof._stat(self.name)
        # no call between a field's read and its write: the interpreter
        # lock cannot pass to another thread inside an update
        st.n += 1
        st.total += ns
        if ns > st.top:
            st.top = ns
        st.window.append(ns / 1e9)
        return False

    @property
    def seconds(self) -> float:
        return self.ns / 1e9


class _RecSpan(_Span):
    """A span opened while the timeline records: also kept in it, with its
    id, block and parent."""

    __slots__ = ("id", "rec")

    def __enter__(self):
        rec = self.rec = _rec
        self.id = None
        if rec is not None:
            stack = _stack()
            if stack:
                top = stack[-1]
                if self.parent is None:
                    self.parent = top[0]
                if self.block is None:
                    self.block = top[1]
            self.id = next(_ticket)
            stack.append((self.id, self.block))
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        _Span.__exit__(self)
        if self.rec is not None:
            _tls.stack.pop()
            _keep(self.rec, self.id, self.name, self.t0, self.t0 + self.ns,
                  self.block, self.parent)
        return False


_new = object.__new__


class BlockProfiler:
    def __init__(self, window: int = 2048):
        self._window = window
        # span name -> _Stat
        self._stats: dict = {}

    def span(self, name: str, block: int = None, parent: int = None):
        """Time a `with` block as span `name`. While the timeline records,
        `block` (default: the enclosing span's) and `parent` (default: the
        enclosing span on this thread) are kept with it."""
        s = _new(_Span if _rec is None else _RecSpan)
        s.prof = self
        s.name = name
        s.block = block
        s.parent = parent
        return s

    def _stat(self, name: str) -> _Stat:
        return self._stats.setdefault(name, _Stat(self._window))

    def record(self, name: str, seconds: float) -> None:
        """A duration timed elsewhere: into the totals and the window, not
        the timeline."""
        st = self._stats.get(name) or self._stat(name)
        ns = round(seconds * 1e9)
        st.n += 1
        st.total += ns
        if ns > st.top:
            st.top = ns
        st.window.append(seconds)

    def totals(self) -> dict[str, dict]:
        """Each span's `count`, `total_s` and `max_s` over the profiler's
        whole life, every thread's together."""
        return {name: {"count": st.n, "total_s": st.total / 1e9,
                       "max_s": st.top / 1e9}
                for name, st in list(self._stats.items()) if st.n}

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, st in list(self._stats.items()):
            values = st.window
            if not values:
                continue
            # deque.copy() is one C-level op under the GIL; iterating the
            # live deque (np.asarray) races the pump thread's appends
            # ("deque mutated during iteration")
            a = np.asarray(values.copy()) * 1e3
            out[name] = {
                "p50_ms": float(np.percentile(a, 50)),
                "p90_ms": float(np.percentile(a, 90)),
                "p99_ms": float(np.percentile(a, 99)),
                "max_ms": float(a.max()),
                "count": int(a.size),
            }
        return out


class SloCounter:
    """Counts block deadline misses (the xrun counter analog)."""

    def __init__(self, budget_seconds: float):
        self.budget = budget_seconds
        self.total_blocks = 0
        self.missed_blocks = 0
        self.worst_overrun = 0.0
        # per-kind (miss, total) attribution: which dispatch path misses —
        # "emit" slices vs "horizon"/"event_rebuild"/"spec" builds vs
        # "adopt" (speculative-horizon adoptions, H-block budget like the
        # builds whose slices they install) vs "per_block" dispatches
        # (untagged observations land in "block")
        self.by_kind: dict = {}
        # dispatch path of the most recent observation — lets harnesses
        # (dryrun_multichip) attribute per-block wall time to a path
        # without threading state through the engine
        self.last_kind: str = ""

    def observe(self, seconds: float, budget_blocks: int = 1,
                kind: str = "block") -> bool:
        """`budget_blocks`: how many blocks of audio this observation
        produced — a lookahead horizon-build block delivers H blocks per
        call, so its deadline is H periods (the pump runs that far ahead;
        the counter predicts dropouts, not per-call latency)."""
        self.total_blocks += 1
        self.last_kind = kind
        budget = self.budget * max(budget_blocks, 1)
        stats = self.by_kind.setdefault(kind, [0, 0, 0.0])
        stats[1] += 1
        if seconds > budget:
            self.missed_blocks += 1
            self.worst_overrun = max(self.worst_overrun, seconds - budget)
            stats[0] += 1
            stats[2] = max(stats[2], seconds - budget)
            return False
        return True

    @property
    def miss_rate(self) -> float:
        return self.missed_blocks / self.total_blocks if self.total_blocks else 0.0


class DspLoad:
    """Smoothed processing-time / period ratio (jack_cpu_load analog)."""

    def __init__(self, period_seconds: float, smoothing: float = 0.9):
        self.period = period_seconds
        self.smoothing = smoothing
        self.load = 0.0

    def observe(self, busy_seconds: float, budget_blocks: int = 1) -> float:
        """`budget_blocks`: blocks of audio this observation produced — a
        lookahead horizon-build block legitimately spends ~H periods and
        must not spike the smoothed load above 1.0 on a healthy engine
        (same scaling SloCounter.observe applies)."""
        instantaneous = busy_seconds / (self.period * max(budget_blocks, 1))
        self.load = self.smoothing * self.load + (1 - self.smoothing) * instantaneous
        return self.load


class EventWatchdog:
    """Delivered-vs-expected event accounting (MidiRouterWatchdog analog,
    lib/MidiRouter.cpp:135-188 — compile-time disabled there; live here).
    AudioEngine.process_block feeds it the router's per-block counts
    (events entering the fabric vs events reaching a terminal — a sink
    append or an intentional swallow). Like the reference's watchdog it
    monitors a STRUCTURAL invariant: today's fabric accounts every event
    by construction, so a mismatch means a regression (an added early
    return / dropped branch / wrapper eating events), caught in
    production instead of silently dropping notes."""

    def __init__(self):
        self.scheduled = 0
        self.delivered = 0
        self.mismatches = 0
        self.lost = 0

    def on_scheduled(self, n: int = 1) -> None:
        self.scheduled += n

    def on_delivered(self, n: int = 1) -> None:
        self.delivered += n

    def check(self) -> bool:
        ok = self.scheduled == self.delivered
        if not ok:
            self.mismatches += 1
        return ok

    def observe_block(self, scheduled: int, delivered: int) -> bool:
        """Per-cycle accounting (the production wiring): totals accumulate,
        a block whose counts disagree records ONE mismatch and the number
        of events lost."""
        self.scheduled += scheduled
        self.delivered += delivered
        ok = scheduled == delivered
        if not ok:
            self.mismatches += 1
            self.lost += scheduled - delivered
        return ok


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """torch.profiler around a region. On exit the device is synchronized
    and a Chrome trace (`trace_<time>_<pid>.json`, for chrome://tracing or
    Perfetto) is written into `log_dir`: CUDA and CPU activity on a CUDA
    device, CPU activity on the CPU. Yields the trace's path."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


# the Chrome trace's process that holds the program's spans: an id no
# process or device of torch.profiler's uses
TRACE_PID = 1 << 30


def add_to_chrome_trace(path: str, spans: list) -> None:
    """Write `spans` (export()'s) into the Chrome trace at `path`
    (torch.profiler's export_chrome_trace, whose events are stamped in
    microseconds after its baseTimeNanoseconds on time.time_ns()'s clock)
    on that clock: a process of its own, sorted first, one track a
    thread."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    events += [
        {"ph": "M", "name": "process_name", "pid": TRACE_PID,
         "args": {"name": "libzl_tpu_torch spans"}},
        {"ph": "M", "name": "process_sort_index", "pid": TRACE_PID,
         "args": {"sort_index": -1}}]
    tids: dict = {}
    for sp in spans:
        thread = sp["thread"]
        if thread not in tids:
            tids[thread] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": TRACE_PID, "tid": tids[thread],
                           "args": {"name": thread}})
        args = {k: sp[k] for k in ("id", "block", "parent", "generation")
                if k in sp}
        events.append({"ph": "X", "cat": "program_span", "name": sp["name"],
                       "pid": TRACE_PID, "tid": tids[thread],
                       "ts": (sp["start_ns"] - base) / 1e3,
                       "dur": (sp["end_ns"] - sp["start_ns"]) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
