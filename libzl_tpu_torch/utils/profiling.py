"""Device tracing on torch.profiler: the port's `device_trace`.

The counterpart of libzl_tpu/utils/profiling.py::device_trace, which wraps
jax.profiler. The host-side timing of that module (BlockProfiler, SloCounter,
DspLoad, EventWatchdog) has no JAX in it; the port uses it from there.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..device import resolve_device


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
