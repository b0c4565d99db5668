"""Compile-once render graphs: one CUDA graph a render shape, replayed a block.

The counterpart of the reference's jit cache. There `render_block_fused` and
`render_horizon_onebuf` are `jax.jit` functions (libzl_tpu/engine/render.py),
`AudioEngine.warmup` compiles every (bucket, rung, kind) executable a session
can dispatch, and `_dispatch_packed` issues one executable a block. The
port's eager render enqueues ~260 small kernels a block (~285 a horizon
slice); here each render shape is captured once in a `torch.cuda.CUDAGraph`
and replayed, one launch a block or horizon.

    host program [n, C] int32 ─> pinned staging slot ─copy_─> static program
                                                              │ replay()
    static bank, static strips ───────────────────────────────┤
                                                              v
                    views of ONE clone <── flat static outputs [all fields]

- `GraphKey` names a shape: kind ("block" or "horizon"), voices rendered
  (the bucket), fetch, rung (max pitch ratio), slices, quirk_gain and the
  bank's shape, dtype and layout. A graph reads the bank, the strips and its
  program where they lay at capture: the engine keeps all three in place
  (`copy_`), and re-binds the graphs when the bank has to grow (`rebind`).
- Capture: a real render of the program on a side stream first (PyTorch's
  CUDA-graph notes: warm up on a side stream), whose outputs are that
  block's; then the capture of the same render, its outputs packed into one
  flat buffer, in the key's own memory pool and in "thread_local" error mode
  (the speculative dispatch thread may launch meanwhile). A capture that
  fails raises; nothing falls back to the eager render.
- Replay, under the key's lock: the program into a pinned staging slot
  (two, each reused only after its last copy finished), one non-blocking
  copy into the static program, `replay()`, one `clone()` of the flat
  outputs, views of it. Outputs are clones, so a bounce drain holding 32
  blocks' outputs, or a horizon emitted while the next renders, stays
  intact. A replay runs exactly the kernels the eager render runs, on the
  same inputs: its bits are the eager render's.
- Launch counts: a kernel wrapper called under capture tallies its launch
  (ops/launch_tally.py) instead of counting it, and every replay adds the
  capture's tally, so `fetch_interp.launches` and `lane_mixdown.launches`
  still count the kernels that ran.
- On the CPU the same keys, static buffers, staging, clone and views run
  with `_PlainGraph`, the graph's plain version: its replay re-runs the
  recorded render on the static buffers. There the capture's one render is
  the block's output and counts its launches (none: the plain versions).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fetch_windows, launch_tally, mixdown
from . import render as render_mod

_FIELDS = len(render_mod.RenderOutputs._fields)


class GraphKey(NamedTuple):
    kind: str            # "block" or "horizon"
    voices: int          # program rows rendered: the bucket
    fetch: str
    rmax: float          # the rung
    slices: int          # H for a horizon, 1 for a block
    quirk_gain: bool
    bank: tuple          # (shape, dtype, layout) of the device bank


def flatten(outs) -> list:
    """The tensors of one render's RenderOutputs, or of a horizon's tuple of
    them, in field order."""
    if isinstance(outs, render_mod.RenderOutputs):
        return list(outs)
    return [t for o in outs for t in o]


def unflatten(flat, layout, horizon: bool):
    """Views of `flat` in the shapes `layout` lists, as the RenderOutputs
    (a tuple of them for a horizon) they were flattened from."""
    views, off = [], 0
    for shape, n in layout:
        views.append(flat[off:off + n].view(shape))
        off += n
    outs = [render_mod.RenderOutputs(*views[i:i + _FIELDS])
            for i in range(0, len(views), _FIELDS)]
    return tuple(outs) if horizon else outs[0]


def _pack(outs, flat) -> None:
    torch.cat([t.reshape(-1) for t in flatten(outs)], out=flat)


def _layout(outs) -> list:
    tensors = flatten(outs)
    dtypes = {t.dtype for t in tensors}
    if dtypes != {torch.float32}:
        raise TypeError(f"render outputs must all be float32, got {dtypes}")
    return [(tuple(t.shape), t.numel()) for t in tensors]


class _PlainGraph:
    """The graph's plain version (the CPU): replay re-runs the recorded
    render on the static program and packs it into the flat outputs. Its
    launches count as a CUDA replay's do: the capture's tally, once."""

    def __init__(self, fn, prog, flat):
        self._fn, self._prog, self._flat = fn, prog, flat

    def replay(self) -> None:
        with launch_tally.recording():
            _pack(self._fn(self._prog), self._flat)


class _Entry:
    """One captured render shape and its static buffers."""

    def __init__(self, key: GraphKey, shape: tuple, device: torch.device):
        cuda = device.type == "cuda"
        self.key = key
        self.lock = threading.Lock()
        self.staging = [torch.empty(shape, dtype=torch.int32, pin_memory=cuda)
                        for _ in range(2)]
        # the copy that last read each staging slot
        self.copied = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self.slot = 0
        self.prog = torch.empty(shape, dtype=torch.int32, device=device)
        # the last replay's clone, on whatever stream it ran
        self.done = torch.cuda.Event() if cuda else None
        self.graph = None
        self.flat = None
        self.layout = None
        self.launches = {}
        self.bytes = 0
        self.dead = False

    def stage(self, prog: np.ndarray) -> None:
        """The host program into a staging slot, then into the static
        program (non-blocking from pinned memory on CUDA)."""
        if tuple(prog.shape) != tuple(self.prog.shape):
            raise ValueError(f"program {tuple(prog.shape)} for a graph of "
                             f"{tuple(self.prog.shape)}")
        self.slot ^= 1
        event = self.copied[self.slot]
        if event is not None:
            event.synchronize()
        np.copyto(self.staging[self.slot].numpy(), prog)
        self.prog.copy_(self.staging[self.slot],
                        non_blocking=event is not None)
        if event is not None:
            event.record()

    def last_program(self) -> np.ndarray:
        return self.staging[self.slot].numpy().copy()


class RenderGraphs:
    """The render graphs of one engine on one device (see the module's
    docstring). `render(key, fn, prog, bound)` replays the key's graph, or
    captures it; `rebind` re-captures every graph on new inputs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: dict = {}
        self._capture_lock = threading.Lock()   # one capture at a time
        self._stats_lock = threading.Lock()
        self._side = None
        # the inputs the graphs read (the engine's bank dict): a render
        # prepared for earlier inputs is stale (see render)
        self.bound = None
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        self.stale = 0
        self.capture_seconds = 0.0
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        return list(self._entries)

    def _device_ctx(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def render(self, key: GraphKey, fn, prog: np.ndarray, bound,
               warm: bool = False) -> tuple:
        """The render of `prog` (host int32) at `key`: a replay of its
        graph, or, the first time, a capture of `fn` (a function of the
        program, host or device, returning RenderOutputs or a tuple of
        them) whose warm-up render is returned. `bound` is the inputs `fn`
        reads: when they are no longer the graphs' (the bank grew while
        this render waited), the render is stale and runs once eagerly,
        without a graph (a speculative horizon's, which the engine then
        discards). A `warm` render (the engine's warmup) is left out
        of `replays`. Returns (outputs, captured)."""
        while True:
            entry = self._entries.get(key)
            if entry is None:
                with self._capture_lock:
                    if key in self._entries:
                        continue
                    if bound is not self.bound:
                        with self._stats_lock:
                            self.stale += 1
                        with self._device_ctx():
                            return fn(prog), False
                    return self._capture(key, fn, prog), True
            with entry.lock:
                if entry.dead:
                    continue
                return self._replay(entry, prog, warm), False

    def _replay(self, entry: _Entry, prog: np.ndarray, warm: bool):
        with self._device_ctx():
            if entry.done is not None:
                torch.cuda.current_stream().wait_event(entry.done)
            entry.stage(prog)
            entry.graph.replay()
            flat = entry.flat.clone()
            if entry.done is not None:
                entry.done.record()
        self._count(entry)
        if not warm:
            with self._stats_lock:
                self.replays += 1
        return unflatten(flat, entry.layout, entry.key.kind == "horizon")

    @staticmethod
    def _count(entry: _Entry) -> None:
        fetch_windows.add_launches(entry.launches.get("fetch_interp", 0))
        mixdown.add_launches(entry.launches.get("lane_mixdown", 0))

    def _capture(self, key: GraphKey, fn, prog: np.ndarray):
        """Capture `fn` at `key` (the capture lock held); returns the
        outputs of the render that went with it."""
        t0 = time.perf_counter()
        entry = _Entry(key, tuple(prog.shape), self.device)
        with self._device_ctx():
            entry.stage(prog)
            if self.device.type == "cuda":
                outs = self._capture_cuda(entry, fn)
            else:
                outs = self._capture_plain(entry, fn)
        entry.bytes += sum(t.numel() * t.element_size() for t in (
            entry.flat, entry.prog, *entry.staging))
        self._entries[key] = entry
        with self._stats_lock:
            self.captures += 1
            self.capture_seconds += time.perf_counter() - t0
            self.bytes += entry.bytes
        return outs

    def _capture_cuda(self, entry: _Entry, fn):
        cur = torch.cuda.current_stream()
        if self._side is None:
            self._side = torch.cuda.Stream()
        side = self._side
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # the warm-up: a real render (its launches count), this block's
            outs = fn(entry.prog)
            entry.layout = _layout(outs)
            entry.flat = torch.empty(sum(n for _, n in entry.layout),
                                     dtype=torch.float32, device=self.device)
            graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(self.device)
            with launch_tally.recording() as tally:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    _pack(fn(entry.prog), entry.flat)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            entry.bytes = torch.cuda.memory_reserved(self.device) - reserved
        cur.wait_stream(side)
        for t in flatten(outs):
            t.record_stream(cur)
        entry.graph = graph
        entry.launches = dict(tally)
        return outs

    def _capture_plain(self, entry: _Entry, fn):
        with launch_tally.recording() as tally:
            outs = fn(entry.prog)
        entry.layout = _layout(outs)
        entry.flat = torch.cat([t.reshape(-1) for t in flatten(outs)])
        entry.graph = _PlainGraph(fn, entry.prog, entry.flat)
        entry.launches = dict(tally)
        # this render is the block's: its launches ran
        self._count(entry)
        return unflatten(entry.flat.clone(), entry.layout,
                         entry.key.kind == "horizon")

    def rebind(self, bound, recapture=None) -> int:
        """The graphs' inputs are now `bound` (the engine's new bank):
        every graph captured on the old ones is dropped, after the device
        finished its replays, and captured again through `recapture(key,
        program columns) -> (new key, fn)` on its last program. Returns the
        number recaptured."""
        with self._capture_lock:
            old = list(self._entries.values())
            self._entries = {}
            for entry in old:
                with entry.lock:
                    entry.dead = True
            if old and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.bound = bound
            with self._stats_lock:
                self.bytes -= sum(e.bytes for e in old)
            for entry in old:
                entry.graph = entry.flat = None
            if recapture is None:
                return 0
            for entry in old:
                key, fn = recapture(entry.key, entry.prog.shape[1])
                self._capture(key, fn, entry.last_program())
            with self._stats_lock:
                self.recaptures += len(old)
            return len(old)

