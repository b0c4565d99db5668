"""The device's side of a `--trace 1` run, from torch.profiler (CUPTI):
every kernel, copy and set that ran on the card in the traced part of the
timed window (its last TRACE_S seconds),
their union (the busy time), each kernel's summed time by name, and the
idle gaps named by what the host was doing then (the harness's own log of
its calls, on the same clock as the profiler's, time since the epoch)."""

from __future__ import annotations

import numpy as np
import torch


# the traced part: the window's last TRACE_S seconds. A whole window of
# the gather path records millions of device ops, and reading them took
# longer than a run may.
TRACE_S = 5.0


def profiler():
    """A profiler of device activity only (no host ops: the window runs
    tens of thousands of blocks); `prepare_trace` before the window,
    `start_trace` TRACE_S before its end, `stop_trace` after it."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def _short(name: str) -> str:
    """A kernel's name without its parameter list (the port's kernels live
    in anonymous namespaces)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:120]


def read(prof, t0_ns: int, t1_ns: int, host_log: list) -> dict:
    """Summarise the device events inside [t0_ns, t1_ns]."""
    spans = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        a, b = int(e.start_ns()), int(e.end_ns())
        if b <= t0_ns or a >= t1_ns or b <= a:
            continue
        spans.append((max(a, t0_ns), min(b, t1_ns), e.name()))
    window_s = (t1_ns - t0_ns) / 1e9
    by_name: dict = {}
    for a, b, name in spans:
        k = _short(name)
        s, n = by_name.get(k, (0.0, 0))
        by_name[k] = (s + (b - a) / 1e9, n + 1)
    if not spans:
        return {"busy_s": 0.0, "window_s": window_s, "ops": by_name,
                "gaps": {}, "events": 0}
    iv = np.array([(a, b) for a, b, _ in spans], np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    run = np.cumsum(new) - 1
    ends = np.zeros(len(starts), np.int64)
    np.maximum.at(ends, run, iv[:, 1])
    busy_s = float((ends - starts).sum()) / 1e9
    # idle gaps: before the first run, between runs, after the last
    gap_a = np.concatenate([[t0_ns], ends])
    gap_b = np.concatenate([starts, [t1_ns]])
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    gaps = {}
    if len(gap_a):
        log = sorted(host_log, key=lambda x: x[1])
        names = [n for n, _, _ in log]
        la = np.array([a for _, a, _ in log], np.int64)
        lb = np.array([b for _, _, b in log], np.int64)
        mid = (gap_a + gap_b) // 2
        i = np.searchsorted(la, mid, side="right") - 1
        for g, (j, m) in enumerate(zip(i, mid)):
            what = (names[j] if j >= 0 and m < lb[j]
                    else "harness between calls")
            s, n, longest = gaps.get(what, (0.0, 0, 0.0))
            d = (gap_b[g] - gap_a[g]) / 1e9
            gaps[what] = (s + d, n + 1, max(longest, d))
    return {"busy_s": busy_s, "window_s": window_s, "ops": by_name,
            "gaps": gaps, "events": len(spans)}


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the device ops that took most time,
    and the idle time by what the host was doing (its total, then its
    longest single gap)."""
    ops = sorted(summary["ops"].items(), key=lambda x: -x[1][0])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda x: -x[1][0])
    idle = []
    for what, (total, n, longest) in gaps[:5]:
        idle.append([f"{what}: all {n} gaps", total])
        idle.append([f"{what}: longest gap", longest])
    return {"device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": idle[:10]}
