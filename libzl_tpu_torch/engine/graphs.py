"""Compile-once render graphs: CUDA graphs a render shape, replayed a block.

The counterpart of the reference's jit cache. There `render_block_fused` and
`render_horizon_onebuf` are `jax.jit` functions (libzl_tpu/engine/render.py),
the mesh's `make_shardmap_packed_render` / `make_shardmap_horizon_render`
too (libzl_tpu/parallel/sharding.py), `AudioEngine.warmup` compiles every
(bucket, rung, kind) executable a session can dispatch, and
`_dispatch_packed` issues one executable a block. The port's eager render
enqueues ~260 small kernels a block and shard (~285 a horizon slice); here
each render shape is captured once and replayed.

    host program [n, C] int32 ─> pinned staging slot ─copy──> static program
                                                              │ launch
    static bank, static strips ───────────────────────────────┤
                                                              v
      an output slot's ready views <─copy── flat static outputs [all fields]

- `GraphKey` names what can differ between two renders of one engine: kind
  ("block" or "horizon"), voices rendered (the bucket), fetch ("windows",
  or "gather" for the over-envelope fallback) and the bank's shape and
  dtype; the rest (H, quirk_gain, the bank's layout, the pitch envelope) is
  the engine's for life. A graph reads the bank, the strips and its
  program where they lay at capture: the engine keeps all three in place
  (`copy_`), and re-binds the graphs when the bank has to grow (`rebind`).
- The segment plan (`parallel/sharding.segments(mesh)`): the mesh's runs of
  shards on one device. One segment (one device, the CPU, or k shards of
  one card) is one graph a key: the whole render, every shard's rows views
  of the one static program. Several segments (cards) are a chain a key,
  because a `torch.cuda.CUDAGraph` records one device's stream: each
  segment's rows staged through its own pinned slots into its card's static
  program, a *contrib* graph and a *fold* graph on that card (the steps of
  `sharding.ShardedRender`, the fold reading a static `init`), and a *tail*
  graph on the first card reading a static mix and static peaks. A replay
  replays every contrib graph (the cards render in parallel), then in mesh
  order copies the previous segment's mix into the static `init` and
  replays the fold (a cross-device `copy_` orders itself after both cards'
  current streams), then copies the last mix and the peaks into the tail's
  inputs and replays the tail. The same kernels run in the same order as
  the eager chain: its bits.
- Capture: a real render of the program first (PyTorch's CUDA-graph notes:
  warm up; a side stream for one graph, the cards' current streams for a
  chain), whose outputs are that block's; then the capture of the same
  render, its outputs packed into one flat buffer, each graph on its
  card's side stream, in its own memory pool and in "thread_local" error
  mode (the speculative dispatch thread may launch meanwhile). A capture
  that fails raises; nothing falls back to the eager render.
- Replay, under the key's lock: each segment's rows into a pinned staging
  slot (two, each reused only after its last copy finished), one
  non-blocking copy into the static program, the replays, one copy of the
  flat outputs into an output slot (`_OutRing`), whose RenderOutputs (a
  tuple of H for a horizon) were built once as its views. A slot is
  written again only when nothing outside the ring refers to it, so a
  bounce drain holding 128 blocks' outputs, or a horizon emitted while
  the next renders, stays intact; where none is free the ring grows, and
  past OUT_RING_BYTES the replay clones the flat outputs instead
  (`out_slot_fallbacks`). On a card a one-segment entry whose capture left
  the default CUDA generator as it was replays in one native call with
  the interpreter lock held (csrc/graph_replay.cu, `_NativeReplay`): the
  program's copy, the graph's launch and the outputs' copy, with handles
  read once at capture; a chain, and a graph that draws from the
  generator, go through torch (`CUDAGraph.replay()`, which advances it).
- Warm replays (`warm`): the engine's warmup replays every graph it
  captured twice on each thread that replays it in realtime, once from each
  staging slot, on the program it last staged (`warm=True`: not counted in
  `replays`), holding every replay's outputs until the last. A graph's
  first launch uploads it, and the held outputs make the key's first two
  output slots: both are paid at boot, not by the first blocks that meet
  the graph. `rebind` warm-replays what it recaptures on the calling
  thread.
- Launch counts: a kernel wrapper called under capture tallies its launch
  (ops/launch_tally.py) instead of counting it; each key's tally (every
  segment's) is registered with its replays (`launch_tally.Replays`), which
  a replay counts up, and a kernel's count, read, adds each tally times its
  replays (a graph `rebind` drops is folded in), so it still says how often
  the kernel ran: the voice kernels and the mixdown k a render (k shards),
  the finish kernel once. Launches that no dispatch of the engine made
  (warm replays, and the warm-up render of each graph `rebind` captures
  again) are also summed, by kernel, in `warm_launches`.
- On the CPU the same keys, segments, static buffers, staging, copies,
  output slots and views run with `_PlainGraph`, a graph's plain version:
  its replay re-runs the recorded step on the static buffers. There one
  segment's capture is the block's output and counts its launches (none:
  the plain versions); a chain's is a warm-up render and its steps.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import sys
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import on_device
from ..ops import launch_tally
from . import render as render_mod

_FIELDS = len(render_mod.RenderOutputs._fields)


# a replay's parts, as BlockProfiler spans in this order: the wait for a
# staging slot's last copy (event.synchronize()); np.copyto into the slot
# (on the torch path also the copy to the device: once a segment); the
# pick of an output slot and the launch tally; the replay: the native
# call, or the graphs' replay() (a chain's copies between cards included)
# and the outputs' copy into the slot (a clone and its views where the
# ring had none), with the segments' end events
DISPATCH_SPANS = ("dispatch_slot_wait", "dispatch_stage", "dispatch_out",
                  "dispatch_replay")

# an entry's output slots may hold this many bytes: a bounce drain holds
# up to 2 x 64 blocks (377 KiB each at B=1024 and 96 voices) and the next
# block renders meanwhile
OUT_RING_BYTES = 64 << 20

_UNTIMED_SPAN = contextlib.nullcontext()


def _untimed(name: str):
    """A span that times nothing: a render given no profiler."""
    return _UNTIMED_SPAN


class GraphKey(NamedTuple):
    kind: str            # "block" or "horizon"
    voices: int          # program rows rendered: the bucket
    fetch: str           # "windows" or "gather"
    bank: tuple          # (shape, dtype) of the device bank


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


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


_gc_lock = threading.Lock()
_gc_held = [0, False]   # captures under way, the collector's state before


@contextlib.contextmanager
def _no_gc():
    """Python's cyclic garbage collector off while any capture, of any
    engine on any thread, is under way; back to its state before after the
    last."""
    with _gc_lock:
        if _gc_held[0] == 0:
            _gc_held[1] = gc.isenabled()
            gc.disable()
        _gc_held[0] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_held[0] -= 1
            if _gc_held[0] == 0 and _gc_held[1]:
                gc.enable()


class _PlainGraph:
    """A graph's plain version (the CPU): replay re-runs the recorded step
    on its static inputs and writes what it returns into the step's static
    outputs, as a CUDA graph's replay rewrites the memory it captured. Its
    launches count as a CUDA replay's do: the capture's tally, once."""

    def __init__(self, step, outs: list):
        self._step, self._outs = step, outs

    def replay(self) -> None:
        with launch_tally.recording():
            for out, t in zip(self._outs, self._step()):
                out.copy_(t)


class _OutSlot:
    """One output slot: a flat buffer, its RenderOutputs (a tuple of H
    for a horizon) as views, and what the ring itself holds of them."""

    __slots__ = ("flat", "ptr", "outs", "objs", "storage", "refs", "uses")


def _unheld(slot: _OutSlot) -> bool:
    """Nothing outside the ring refers to `slot`: every object it handed
    out (the flat buffer, the outputs' tuples and their fields) is back to
    its reference count at the slot's making, and the buffer's storage to
    its use count (a view, a slice or a numpy array made from a field
    holds the storage). The reference counts are read first: a holder
    that makes a view and then drops its field is seen by one or the
    other. Holding a field only from C++ (a DLPack capsule) is not seen."""
    return (sum(map(sys.getrefcount, slot.objs)) == slot.refs
            and torch._C._storage_Use_Count(slot.storage) == slot.uses)


class _OutRing:
    """An entry's output slots, made on demand, each written again only
    when `_unheld`. `take()` returns the first such slot from the one
    after the last taken, else a new one, else None once the slots hold
    OUT_RING_BYTES (the caller clones: out_slot_fallbacks). Under the
    entry's lock."""

    def __init__(self, layout, horizon: bool, device: torch.device):
        self.layout, self.horizon, self.device = layout, horizon, device
        self.numel = sum(n for _, n in layout)
        self.cap = max(OUT_RING_BYTES // (4 * self.numel), 1)
        self.slots = []
        self._next = 0

    def take(self):
        slots = self.slots
        n = len(slots)
        i = self._next
        for _ in range(n):
            if i >= n:
                i = 0
            if _unheld(slots[i]):
                self._next = i + 1
                return slots[i]
            i += 1
        if n >= self.cap:
            return None
        # the new slot goes where the search began: the ring's order stays
        # that of last use
        i = min(self._next, n)
        slots.insert(i, self._make())
        self._next = i + 1
        return slots[i]

    def _make(self) -> _OutSlot:
        slot = _OutSlot()
        slot.flat = torch.empty(self.numel, dtype=torch.float32,
                                device=self.device)
        slot.ptr = slot.flat.data_ptr()
        slot.outs = unflatten(slot.flat, self.layout, self.horizon)
        outs = slot.outs if self.horizon else (slot.outs,)
        slot.objs = [slot.flat, *outs, *(t for o in outs for t in o)]
        if self.horizon:
            slot.objs.append(slot.outs)
        del outs
        slot.storage = slot.flat.untyped_storage()._cdata
        slot.refs = sum(map(sys.getrefcount, slot.objs))
        slot.uses = torch._C._storage_Use_Count(slot.storage)
        return slot


class _NativeReplay:
    """A one-segment card entry's replay in one native call
    (csrc/graph_replay.cu), its handles read once at capture as plain
    ints: the graph's executable, the staging slots, their `copied`
    events, the static program, the static flat outputs and `done`."""

    __slots__ = ("call", "exec", "done", "prog", "prog_bytes", "staging",
                 "copied", "src", "out_bytes", "index")

    def __init__(self, entry: "_Entry", graph, device: torch.device):
        from .. import _build

        seg = entry.segments[0]
        with on_device(device):
            for event in (*seg.copied, seg.done):
                event.record()  # makes it, on the device
            # the device the graph was captured on
            self.index = torch.cuda.current_device()
        self.call = _build.load_held().zl_graph_replay
        self.exec = int(graph.raw_cuda_graph_exec())
        self.done = seg.done.cuda_event
        self.prog = seg.prog.data_ptr()
        self.prog_bytes = seg.prog.numel() * seg.prog.element_size()
        self.staging = [t.data_ptr() for t in seg.staging]
        self.copied = [e.cuda_event for e in seg.copied]
        self.src = entry.flat.data_ptr()
        self.out_bytes = entry.flat.numel() * entry.flat.element_size()

    def __call__(self, slot: int, dst: int) -> None:
        """Enqueue the replay of the program in staging slot `slot`, its
        outputs copied to `dst`, on the current stream."""
        code = self.call(self.exec,
                         torch._C._cuda_getCurrentRawStream(self.index),
                         self.done, self.prog, self.staging[slot],
                         self.prog_bytes, self.copied[slot], dst, self.src,
                         self.out_bytes, self.index)
        if code:
            from .. import _build

            _build.check(_build.load(), code, "zl_graph_replay")


class _Segment:
    """One segment's rows of a key's program: pinned staging slots, the
    static program on the segment's device, and a chain's graphs there."""

    def __init__(self, device: torch.device, rows: slice, cols: int):
        cuda = device.type == "cuda"
        shape = (rows.stop - rows.start, cols)
        self.device = device
        self.rows = rows
        self.staging = [torch.empty(shape, dtype=torch.int32, pin_memory=cuda)
                        for _ in range(2)]
        self.staging_np = [t.numpy() for t in self.staging]
        # the copy that last read each staging slot
        self.copied = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self.slot = 0
        self.prog = torch.empty(shape, dtype=torch.int32, device=device)
        # the last replay's end on this device, on whatever stream it ran
        self.done = torch.cuda.Event() if cuda else None
        # a chain's: the contrib graph and its outputs (each shard's
        # contributions and lanes, the segment's peaks), the fold graph,
        # its static init (None for the first segment) and its mix
        self.contrib = self.parts = self.peaks = None
        self.fold = self.init = self.mix = None

    def next_slot(self, span=_untimed) -> int:
        """The other staging slot, once its last copy finished (span
        dispatch_slot_wait)."""
        self.slot ^= 1
        event = self.copied[self.slot]
        with span("dispatch_slot_wait"):
            if event is not None:
                event.synchronize()
        return self.slot

    def stage(self, prog: np.ndarray, span=_untimed) -> None:
        """The segment's rows of the host program into a staging slot, then
        into the static program (non-blocking from pinned memory on CUDA),
        on the device's current stream after the last replay's end: the
        copies in span dispatch_stage."""
        if self.done is not None:
            torch.cuda.current_stream().wait_event(self.done)
        i = self.next_slot(span)
        event = self.copied[i]
        with span("dispatch_stage"):
            np.copyto(self.staging_np[i], prog[self.rows])
            self.prog.copy_(self.staging[i], non_blocking=event is not None)
            if event is not None:
                event.record()

    def statics(self) -> list:
        return [self.prog, self.init, *self.staging]


class _Entry:
    """One captured render shape: its segments and static buffers."""

    def __init__(self, key: GraphKey, shape: tuple, plan: list):
        self.key = key
        self.lock = threading.Lock()
        self.shape = tuple(shape)
        s = shape[0] // sum(n for _, _, n in plan)
        self.segments = [_Segment(dev, slice(a * s, (a + n) * s), shape[1])
                         for dev, a, n in plan]
        self.graph = None        # one segment's render; a chain's tail
        self.mix_in = None       # a chain's tail inputs
        self.peaks_in = None
        self.flat = None
        self.layout = None
        self.out = None          # the output slots (_OutRing)
        self.native = None       # a _NativeReplay, where it may be used
        self.launches = {}
        self.replayed = launch_tally.Replays(self.launches, self)
        self.bytes = 0
        self.dead = False
        # the threads (by name) that warm-replayed this graph
        self.warmed = set()

    def stage(self, prog: np.ndarray, span=_untimed) -> None:
        """Every segment's rows staged (_Segment.stage)."""
        if tuple(prog.shape) != self.shape:
            raise ValueError(f"program {tuple(prog.shape)} for a graph of "
                             f"{self.shape}")
        for seg in self.segments:
            with on_device(seg.device):
                seg.stage(prog, span)

    def last_program(self) -> np.ndarray:
        return np.concatenate([seg.staging_np[seg.slot]
                               for seg in self.segments])

    def statics(self) -> list:
        return [self.flat, self.mix_in, *(self.peaks_in or []),
                *(t for seg in self.segments for t in seg.statics())]

class RenderGraphs:
    """The render graphs of one engine (see the module's docstring).
    `segments` is the plan its renders split into (sharding.segments(mesh);
    default one segment on `device`), `device` the first segment's, where
    the outputs land. `render(key, fn, prog, bound)` replays the key's
    graphs, or captures them; `rebind` re-captures every graph on new
    inputs."""

    def __init__(self, device, segments=None):
        self.device = torch.device(device)
        self.plan = list(segments or [(self.device, 0, 1)])
        if self.plan[0][0] != self.device:
            raise ValueError(f"the plan starts on {self.plan[0][0]}, the "
                             f"outputs land on {self.device}")
        self._entries: dict = {}
        self._capture_lock = threading.Lock()   # one capture at a time
        self._stats_lock = threading.Lock()
        self._side = {}                         # device -> capture stream
        # the inputs the graphs read (the engine's bank dict): a render
        # prepared for earlier inputs is stale (see render)
        self.bound = None
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        self.warm_replays = 0
        # replays (not warm) through the native call; output slots made;
        # replays that found no slot and cloned
        self.native_replays = 0
        self.out_slots = 0
        self.out_slot_fallbacks = 0
        # launches no engine dispatch made, by kernel (module docstring)
        self.warm_launches = collections.Counter()
        self.stale = 0
        self.capture_seconds = 0.0
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        return list(self._entries)

    def warm(self, keys=None) -> int:
        """Replay each graph of `keys` (default: every one) on the calling
        thread twice, once from each staging slot, on the program it last
        staged: the same program staged again, counted in `warm_replays`,
        not `replays`. Every replay's outputs are held until the last
        returns, so the caching allocator keeps a block for each: the
        realtime path holds several at once (a block and the one before
        it, a horizon being emitted and the chain's next ones). Marks each
        entry warmed on this thread. Returns the replays."""
        held = []
        for key in self.keys() if keys is None else keys:
            entry = self._entries.get(key)
            if entry is None:
                continue
            with entry.lock:
                if entry.dead:
                    continue
                prog = entry.last_program()
                for _ in entry.segments[0].staging:
                    held.append(self._replay(entry, prog, warm=True))
                entry.warmed.add(threading.current_thread().name)
        with self._stats_lock:
            self.warm_replays += len(held)
        return len(held)

    def replay(self, key: GraphKey, prog: np.ndarray, warm: bool = False,
               profiler=None):
        """The replay of `key`'s graphs on `prog`, as `render` replays
        them, or None where `key` has none (render then captures)."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        with entry.lock:
            if entry.dead:
                return None
            return self._replay(entry, prog, warm, profiler)

    def render(self, key: GraphKey, fn, prog: np.ndarray, bound,
               warm: bool = False, profiler=None) -> tuple:
        """The render of `prog` (host int32) at `key`: a replay of its
        graphs, or, the first time, a capture of `fn` whose warm-up render
        is returned. `fn(prog)` renders a program (host, or a device
        tensor) into RenderOutputs or a tuple of them; a chained plan also
        uses its steps (`fn.contrib`, `fn.fold`, `fn.tail`, `fn.chain`: a
        sharding.ShardedRender). `bound` is the inputs `fn` reads: when
        they are no longer the graphs' (the bank grew while this render
        waited), the render is stale and runs once eagerly, without a
        graph (a speculative horizon's, which the engine then discards). A
        `warm` render (the engine's warmup) is left out of `replays`. A
        replay records its parts on `profiler` (a BlockProfiler), when
        given, as the spans DISPATCH_SPANS. Returns (outputs, captured)."""
        while True:
            out = self.replay(key, prog, warm, profiler)
            if out is not None:
                return out, False
            with self._capture_lock:
                if key in self._entries:
                    continue
                if bound is not self.bound:
                    with self._stats_lock:
                        self.stale += 1
                    with on_device(self.device):
                        return fn(prog), False
                return self._capture(key, fn, prog), True

    def _replay(self, entry: _Entry, prog: np.ndarray, warm: bool,
                profiler=None):
        """One replay of `entry` on `prog` (its lock held), its parts timed
        as the spans DISPATCH_SPANS on `profiler`."""
        span = _untimed if profiler is None else profiler.span
        native = entry.native
        if native is None:
            entry.stage(prog, span)
        else:
            if tuple(prog.shape) != entry.shape:
                raise ValueError(f"program {tuple(prog.shape)} for a graph "
                                 f"of {entry.shape}")
            seg = entry.segments[0]
            i = seg.next_slot(span)
            with span("dispatch_stage"):
                np.copyto(seg.staging_np[i], prog)
        with span("dispatch_out"):
            out = entry.out
            slots = len(out.slots)
            slot = out.take()
            entry.replayed.n += 1
            with self._stats_lock:
                if warm:
                    self.warm_launches.update(entry.launches)
                else:
                    self.replays += 1
                    self.native_replays += native is not None
                self.out_slots += len(out.slots) - slots
                self.out_slot_fallbacks += slot is None
        with span("dispatch_replay"):
            if native is not None:
                if slot is not None:
                    native(i, slot.ptr)
                    return slot.outs
                flat = torch.empty_like(entry.flat)
                native(i, flat.data_ptr())
            else:
                flat = self._replay_torch(entry, slot)
                if slot is not None:
                    return slot.outs
            return unflatten(flat, entry.layout, entry.key.kind == "horizon")

    def _replay_torch(self, entry: _Entry, slot):
        """The graphs' replay() through torch (the entry's program staged),
        the flat outputs copied into `slot`, else cloned (returned)."""
        segs = entry.segments
        # one entry into the outputs' device for the replay and the copy:
        # entering a CUDA device costs tens of µs of host time
        with on_device(self.device):
            if entry.mix_in is not None:
                for seg in segs:
                    with on_device(seg.device):
                        seg.contrib.replay()
                for prev, seg in zip([None] + segs, segs):
                    with on_device(seg.device):
                        if prev is not None:
                            seg.init.copy_(prev.mix)
                        seg.fold.replay()
                entry.mix_in.copy_(segs[-1].mix)
                for dst, seg in zip(entry.peaks_in, segs):
                    dst.copy_(seg.peaks)
            entry.graph.replay()
            flat = entry.flat.clone() if slot is None else \
                slot.flat.copy_(entry.flat)
            for seg in segs:
                if seg.done is not None:
                    with on_device(seg.device):
                        seg.done.record()
        return flat

    def _capture(self, key: GraphKey, fn, prog: np.ndarray):
        """Capture `fn` at `key` (the capture lock held); returns the
        outputs of the render that went with it."""
        t0 = time.perf_counter()
        entry = _Entry(key, tuple(prog.shape), self.plan)
        entry.stage(prog)
        if len(self.plan) > 1:
            outs = self._capture_chain(entry, fn)
        elif self.device.type == "cuda":
            outs = self._capture_cuda(entry, fn)
        else:
            outs = self._capture_plain(entry, fn)
        entry.bytes += _nbytes(entry.statics())
        entry.out = _OutRing(entry.layout, key.kind == "horizon",
                             self.device)
        self._entries[key] = entry
        with self._stats_lock:
            self.captures += 1
            self.capture_seconds += time.perf_counter() - t0
            self.bytes += entry.bytes
        return outs

    def _record(self, entry: _Entry, device: torch.device, step) -> tuple:
        """A graph of `step()` (a list of tensors: the graph's static
        outputs) on `device`: a CUDA graph captured on the device's side
        stream in its own pool, or the plain version on the CPU. Its
        launches go into the entry's tally. Returns (graph, outputs)."""
        if device.type != "cuda":
            with launch_tally.recording() as tally:
                outs = step()
            graph = _PlainGraph(step, outs)
        else:
            with on_device(device):
                cur = torch.cuda.current_stream()
                side = self._side.get(device)
                if side is None:
                    side = self._side[device] = torch.cuda.Stream()
                side.wait_stream(cur)
                reserved = torch.cuda.memory_reserved(device)
                # no garbage collection on this thread while it captures:
                # collecting an orphaned engine's graphs destroys them, which
                # a capturing stream does not permit (the capture fails)
                with torch.cuda.stream(side), _no_gc(), \
                        launch_tally.recording() as tally:
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        outs = step()
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                entry.bytes += torch.cuda.memory_reserved(device) - reserved
                cur.wait_stream(side)
        for name, n in tally.items():
            entry.launches[name] = entry.launches.get(name, 0) + n
        return graph, outs

    def _capture_cuda(self, entry: _Entry, fn):
        """One segment on a card: the warm-up render on the side stream,
        then one graph of the whole render, replayed by the native call
        unless the two drew from the default CUDA generator."""
        prog = entry.segments[0].prog
        rng = torch.cuda.get_rng_state(self.device)
        with on_device(self.device):
            cur = torch.cuda.current_stream()
            if self.device not in self._side:
                self._side[self.device] = torch.cuda.Stream()
            side = self._side[self.device]
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                # the warm-up: a real render (its launches count), this
                # block's
                outs = fn(prog)
            cur.wait_stream(side)
            for t in flatten(outs):
                t.record_stream(cur)
            entry.layout = _layout(outs)
            entry.flat = torch.empty(sum(n for _, n in entry.layout),
                                     dtype=torch.float32, device=self.device)
        entry.graph, _ = self._record(
            entry, self.device, lambda: _pack(fn(prog), entry.flat) or [])
        # CUDAGraph.replay() advances the default CUDA generator by what the
        # graph draws from it (its replay prologue); the native call does
        # not: it takes only a graph whose render left the generator as it
        # was
        if torch.equal(torch.cuda.get_rng_state(self.device), rng):
            entry.native = _NativeReplay(entry, entry.graph, self.device)
        return outs

    def _capture_plain(self, entry: _Entry, fn):
        """One segment on the CPU: the plain capture's render is the
        block's, and counts its launches."""
        prog = entry.segments[0].prog
        with launch_tally.recording() as tally:
            outs = fn(prog)
        entry.layout = _layout(outs)
        entry.flat = torch.cat([t.reshape(-1) for t in flatten(outs)])
        entry.graph = _PlainGraph(lambda: _pack(fn(prog), entry.flat) or [],
                                  [])
        entry.launches.update(tally)
        # this render is the block's: its launches ran
        launch_tally.add(entry.launches)
        return unflatten(entry.flat.clone(), entry.layout,
                         entry.key.kind == "horizon")

    def _capture_chain(self, entry: _Entry, fn):
        """Several segments: the warm-up (the eager chain on the static
        programs, this block's outputs, its launches counted), then each
        segment's contrib graph, each fold graph (from a static init after
        the first), and the tail graph on the first device."""
        segs = entry.segments
        outs = fn.chain(self.plan, [seg.prog for seg in segs])
        entry.layout = _layout(outs)
        rows = entry.shape[0]
        for plan_seg, seg in zip(self.plan, segs):
            def contrib(plan_seg=plan_seg, seg=seg):
                parts, peaks = fn.contrib(plan_seg, seg.prog)
                return [t for part in parts for t in part] + [peaks]
            seg.contrib, got = self._record(entry, seg.device, contrib)
            seg.parts = list(zip(got[:-1:2], got[1:-1:2]))
            seg.peaks = got[-1]
        prev = None
        for plan_seg, seg in zip(self.plan, segs):
            if prev is not None:
                seg.init = torch.zeros_like(prev.mix, device=seg.device)

            def fold(plan_seg=plan_seg, seg=seg):
                return [fn.fold(plan_seg, seg.parts, seg.init)]
            seg.fold, (seg.mix,) = self._record(entry, seg.device, fold)
            prev = seg
        entry.mix_in = torch.zeros_like(prev.mix, device=self.device)
        entry.peaks_in = [torch.zeros_like(seg.peaks, device=self.device)
                          for seg in segs]

        entry.flat = torch.empty(sum(n for _, n in entry.layout),
                                 dtype=torch.float32, device=self.device)
        entry.graph, _ = self._record(entry, self.device, lambda: _pack(
            fn.tail(entry.mix_in, entry.peaks_in, rows), entry.flat) or [])
        return outs

    def rebind(self, bound, recapture=None) -> int:
        """The graphs' inputs are now `bound` (the engine's new bank):
        every graph captured on the old ones is dropped, after the devices
        finished their replays, and captured again through `recapture(key,
        program columns) -> (new key, fn)` on its last program, then
        warm-replayed on the calling thread (warm). Returns the number
        recaptured."""
        with self._capture_lock:
            old = list(self._entries.values())
            self._entries = {}
            for entry in old:
                with entry.lock:
                    entry.dead = True
                launch_tally.retire(entry.replayed)
            for dev in dict.fromkeys(d for d, _, _ in self.plan):
                if old and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.bound = bound
            with self._stats_lock:
                self.bytes -= sum(e.bytes for e in old)
            for entry in old:   # free the pools and static buffers
                entry.graph = entry.flat = entry.native = entry.out = None
                entry.mix_in = entry.peaks_in = None
                for seg in entry.segments:
                    seg.contrib = seg.fold = seg.parts = seg.peaks = None
                    seg.init = seg.mix = None
            if recapture is None:
                return 0
            for entry in old:
                key, fn = recapture(entry.key, entry.shape[1])
                self._capture(key, fn, entry.last_program())
                # its warm-up render launched what the graph holds
                with self._stats_lock:
                    self.warm_launches.update(self._entries[key].launches)
            with self._stats_lock:
                self.recaptures += len(old)
        self.warm()
        return len(old)
