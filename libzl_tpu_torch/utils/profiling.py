"""Per-block timing, SLO accounting, xrun-analog detection, device tracing.

The counterpart of libzl_tpu/utils/profiling.py. Its host-side timing
(BlockProfiler, SloCounter, DspLoad, EventWatchdog) is the reference's code,
copied verbatim; `device_trace` wraps torch.profiler where the reference's
wraps jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque

import numpy as np
import torch

from ..device import resolve_device


class BlockProfiler:
    def __init__(self, window: int = 2048):
        self._samples: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, values in list(self._samples.items()):
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
