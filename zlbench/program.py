"""Readings of the program's own span record (libzl_tpu_torch.utils.profiling)
for the benchmark: the device's idle gaps named by the program's spans
(`gap_pieces`, `name_gaps`), the speculative workers' busy share
(`spec_busy_pct`) and their share of the late blocks (`late_spec_pct`), and
the lookahead's useful share (`lookahead_useful_pct`).

Pure functions of intervals and readings, tested on the CPU
(tests/test_torch_tracing.py). No benchmark line reads them yet: they take
what `profiling.export()` and `AudioEngine.stats()` give over a window,
which the harness does not record.
"""

from __future__ import annotations

import bisect

import numpy as np

# the thread that drives the runtime in the benchmark's windows
RUNTIME_THREAD = "engine"
WORKER_SPANS = ("spec_sim", "spec_dispatch")


def innermost(spans) -> list:
    """Disjoint (start, end, name) pieces, in time order, of the instants
    that `spans` ((start, end, name), one thread's, so nested) cover, each
    named by the innermost span over it. A span reaching past the one
    around it is cut at its end."""
    pieces = []
    stack = []      # (end, name) of the open spans, outermost first
    t = None        # pieces are emitted up to here
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            if end > t:
                pieces.append((t, end, top))
                t = end
        if stack:
            if a > t:
                pieces.append((t, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        t = a if t is None else max(t, a)
        if b > a:
            stack.append((b, name))
    while stack:
        end, top = stack.pop()
        if end > t:
            pieces.append((t, end, top))
            t = end
    return pieces


def _split(a: int, b: int, pieces: list, ends: list):
    """[a, b) cut by `pieces` (innermost's): (start, end, name or None)."""
    i = bisect.bisect_right(ends, a)
    t = a
    while t < b and i < len(pieces):
        pa, pb, name = pieces[i]
        if pa >= b:
            break
        if pa > t:
            yield t, pa, None
            t = pa
        e = min(pb, b)
        yield t, e, name
        t = e
        i += 1
    if t < b:
        yield t, b, None


def gap_pieces(gaps, spans, host_log):
    """Each idle gap ((start, end) ns) cut into (start, end, name) pieces:
    the innermost program span over it (`spans`: (start, end, name) of the
    thread that drives the runtime), where none is open the harness's
    call then (`host_log`: (name, start, end), as trace.read takes it),
    else "harness between calls"."""
    prog = innermost(spans)
    prog_ends = [p[1] for p in prog]
    host = innermost([(a, b, n) for n, a, b in host_log])
    host_ends = [p[1] for p in host]
    for ga, gb in gaps:
        for a, b, name in _split(ga, gb, prog, prog_ends):
            if name is not None:
                yield a, b, name
                continue
            for c, d, what in _split(a, b, host, host_ends):
                yield c, d, what or "harness between calls"


def name_gaps(gaps, spans, host_log) -> dict:
    """The idle gaps' time by name (gap_pieces)."""
    return by_name(gap_pieces(gaps, spans, host_log))


def by_name(pieces) -> dict:
    """{name: (seconds, pieces, longest piece in seconds)} of (start, end,
    name) pieces in ns: trace.read's `gaps` format."""
    out: dict = {}
    for a, b, name in pieces:
        d = (b - a) / 1e9
        s, n, longest = out.get(name, (0.0, 0, 0.0))
        out[name] = (s + d, n + 1, max(longest, d))
    return out


def union(iv) -> np.ndarray:
    """Sorted disjoint rows covering the (start, end) intervals `iv`."""
    if not len(iv):
        return np.zeros((0, 2), np.int64)
    iv = np.asarray(iv, np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    ends = np.zeros(len(starts), np.int64)
    np.maximum.at(ends, np.cumsum(new) - 1, iv[:, 1])
    return np.stack([starts, ends], 1)


def spans_of(record: dict, thread: str = None, names=None) -> list:
    return [s for s in record["spans"]
            if (thread is None or s["thread"] == thread)
            and (names is None or s["name"] in names)]


def spec_busy_pct(record: dict, t0_ns: int, t1_ns: int):
    """spec_busy_pct.live: the union of the speculative workers' spans
    (spec_sim, spec_dispatch) over [t0_ns, t1_ns], %."""
    iv = [(max(s["start_ns"], t0_ns), min(s["end_ns"], t1_ns))
          for s in spans_of(record, names=WORKER_SPANS)]
    iv = [x for x in iv if x[1] > x[0]]
    if t1_ns <= t0_ns:
        return None
    u = union(iv)
    return float((u[:, 1] - u[:, 0]).sum()) / (t1_ns - t0_ns) * 100


def late_spec_pct(run, record: dict):
    """late_spec_pct.live: of the window's blocks later than a period
    (xrun_pct.live's rule), the % whose `step` (matched by block number:
    the window's first step is its block 0) overlapped a speculative
    worker's span. None when no block was late."""
    if run.drive != "live" or run.delivered is None:
        return None
    steps = {s["block"]: s
             for s in spans_of(record, RUNTIME_THREAD, ("step",))}
    if not steps:
        return None
    b0 = min(steps)
    work = union([(s["start_ns"], s["end_ns"])
                  for s in spans_of(record, names=WORKER_SPANS)])
    late = np.nonzero((run.delivered - run.due) > run.period_s)[0]
    hits = n = 0
    for i in late:
        st = steps.get(b0 + int(i))
        if st is None:
            continue
        n += 1
        j = np.searchsorted(work[:, 1], st["start_ns"], side="right")
        hits += bool(j < len(work) and work[j, 0] < st["end_ns"])
    return hits / n * 100 if n else None


def lookahead_useful_pct(before: dict, after: dict):
    """lookahead_useful_pct.live: horizon slices emitted over slices
    rendered (AudioEngine.stats()) between two readings, %."""
    rendered = (after["lookahead_slices_rendered"]
                - before["lookahead_slices_rendered"])
    emitted = (after["lookahead_slices_emitted"]
               - before["lookahead_slices_emitted"])
    return emitted / rendered * 100 if rendered else None
