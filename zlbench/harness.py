"""One run of one cell: the session set up through the port's C ABI runtime,
the timed window, the metrics read, the reference's check.

The window drives `libzl_tpu_torch.capi.bridge.EngineRuntime` at the
engine's card defaults (lookahead, render graphs, bounce drain and voice
buckets "auto") into a sink of this folder's:

- "bounce": `step_blocks` back to back (the runtime's offline bounce), a
  non-pacing in-memory sink, so the bounce drain takes the blocks; no
  wall-clock pump (it paces at 1x realtime);
- "live": an open loop standing in for the sound card's period callback:
  block n is due at t0 + n * period and is rendered by one `step_blocks(1)`
  at its due time, or at once when the loop is late, into a pacing
  in-memory sink (each block delivered on its own). The traffic's timed
  commands (live notes, the event kinds of `spec.event_kinds`) go to the
  engine under the runtime's lock right before the block they are sent
  for, as a hardware MIDI input's would, before the block's timed part
  starts. The pump's run-ahead of H + 2 blocks is left out: it is output
  latency a player would hear.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time

import numpy as np

from . import reference, session

LIVE_SWITCH_S = 0.001

# what no process of the benchmark may have loaded, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "libzl_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class MemorySink:
    """The runtime's audio sink (io/sinks.AudioSink's interface): the host
    clock when each block arrived, and a copy of the master mix of the
    blocks `keep(index)` names and of the last one. Keeping every block
    would grow the process by hundreds of MB during the window."""

    name = "zlbench"

    def __init__(self, pacing: bool):
        self.pacing = pacing
        self.keep = lambda index: False
        self.kept: dict = {}
        self.last = None
        self.times: list = []
        self.count = 0
        self.frames = 0

    def write(self, block: np.ndarray) -> None:
        self.times.append(time.perf_counter())
        copy = np.array(block, np.float32)
        if self.keep(self.count):
            self.kept[self.count] = copy
        self.last = (self.count, copy)
        self.count += 1
        self.frames += int(block.shape[0])

    def block(self, index: int):
        """A kept block's master, or None."""
        if self.last is not None and self.last[0] == index:
            return self.last[1]
        return self.kept.get(index)

    def close(self) -> None:
        pass


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers take it."""

    cell: str
    drive: str
    block_frames: int
    sample_rate: int
    setup_s: float
    t0: float = 0.0            # the window's start (host clock)
    window_s: float = 0.0
    blocks: int = 0            # blocks rendered in the window
    frames: int = 0            # frames the sink received in the window
    due: np.ndarray = None     # live: each block's due time (host clock)
    started: np.ndarray = None   # live: when its step_blocks(1) began
    delivered: np.ndarray = None  # when its master reached the sink
    phases: dict = None        # the runtime's phase totals over the window
    counters: dict = None      # engine.stats()'s numbers over the window
    spans: dict = None         # the engine's span summaries over the window
    trace: dict = None         # trace.read's device summary (--trace 1)
    work: dict = None          # the window's work, counted by the reference

    @property
    def period_s(self) -> float:
        return self.block_frames / self.sample_rate


def phase_totals(rt) -> dict:
    """The runtime's cumulative phase times (s) and counts."""
    st = rt.phase_stats()
    return {k[:-3]: (st[k] / 1e3, st[k[:-3] + "_n"])
            for k in st if k.endswith("_ms")}


def phase_delta(before: dict, after: dict) -> dict:
    return {k: (s - before.get(k, (0.0, 0))[0], n - before.get(k, (0.0, 0))[1])
            for k, (s, n) in after.items()}


def engine_counters(engine) -> dict:
    """The numeric entries of the engine's `stats()` (counts and levels;
    its flags, names and nested entries left out)."""
    return {k: v for k, v in engine.stats().items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def counter_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


@dataclasses.dataclass
class Session:
    rt: object
    sink: MemorySink
    clips: list            # session.Clip
    loops: list            # session.LoopVoice
    port_clips: list       # the port's ClipAudioSource of each clip
    setup_blocks: int


def build(cell, seed: int, device: str) -> Session:
    """The runtime at its defaults, the clips loaded, the sampler channels
    mapped, the loops started, warmed up and the first blocks rendered."""
    from libzl_tpu_torch.capi.bridge import EngineRuntime
    from libzl_tpu_torch.engine.commands import ClipCommand
    from libzl_tpu_torch.io.wav import AudioData
    from libzl_tpu_torch.midi.router import Destination
    from libzl_tpu_torch.models.clip import ClipAudioSource

    cfg = cell.config
    mark = _marker()
    rt = EngineRuntime(sample_rate=cfg["sample_rate"],
                       block_frames=cfg["block_frames"],
                       num_voices=cfg["num_voices"], device=device,
                       **cfg["runtime"])
    sink = MemorySink(pacing=cfg["drive"] == "live")
    rt.set_sink(sink)
    mark("runtime built")
    clips = session.make_clips(cfg, seed, device)
    loops = session.loop_plan(int(cell.traffic["loop_voices"]), len(clips),
                              seed)
    mark("clips made")
    engine = rt.engine
    attack, decay, sustain, release = cfg["adsr"]

    def load():
        ports = []
        for c in clips:
            p = ClipAudioSource(engine, audio=AudioData(c.audio,
                                                        cfg["sample_rate"]))
            p.adsr_attack, p.adsr_decay = attack, decay
            p.adsr_sustain, p.adsr_release = sustain, release
            p.root_note = cfg["root_note"]
            p.set_volume_absolute(cfg["clip_volume"])
            ports.append(p)
        for ch in range(session.NUM_CHANNELS):
            engine.router.set_channel_destination(ch, Destination.SAMPLER)
            engine.sampler_map.assign(
                ch, ports[session.keys_clip(ch, len(ports))])
        engine.start_transport(bpm=cfg["bpm"])
        for v in loops:
            cmd = ClipCommand.channel(ports[v.clip].id, v.channel)
            cmd.midi_note = v.note
            cmd.change_volume = True
            cmd.volume = v.volume
            cmd.looping = True
            cmd.start_playback = True
            engine.schedule_clip_command(cmd, 0)
        return ports

    ports = rt.run_locked(load)
    mark("session loaded")
    if cfg["drive"] == "live":
        # the interpreter switch interval the runtime sets when it goes
        # live (EngineRuntime.start_pump's LIBZL_TPU_GIL_SWITCH_MS default),
        # so the speculative workers cannot hold the callback for 5 ms
        sys.setswitchinterval(LIVE_SWITCH_S)
    engine.warmup()
    mark("warmed up")
    n = int(cfg["setup_blocks"])
    if cfg["drive"] == "live":
        for _ in range(n):
            rt.step_blocks(1)
    else:
        rt.step_blocks(n)
    mark(f"first {n} blocks rendered")
    return Session(rt, sink, clips, loops, ports, n)


@dataclasses.dataclass
class Window:
    """What an event kind sees of one run: the cell, the session, the seed,
    and the window's length, period and blocks (a live window's, known
    before it)."""

    cell: object
    session: Session
    seed: int
    seconds: float
    period_s: float

    @property
    def first(self) -> int:
        """The sink index of the window's first block."""
        return self.session.setup_blocks

    @property
    def blocks(self) -> int:
        return live_blocks(self.seconds, self.period_s)


@dataclasses.dataclass
class Plan:
    """One event kind's window: `commands`, (window block, command) in the
    order they are sent, a block's commands right before it; `keep`, the
    sink indices the check keeps, decided before the window (where the
    program decides a command's effect block, a span after its send);
    `state`, the kind's own (what `read` found)."""

    commands: list
    keep: set
    state: dict = dataclasses.field(default_factory=dict)


def plan_events(w: Window) -> list:
    """Each of the cell's event kinds with its plan: [(module, Plan)]."""
    return [(mod, mod.plan(params, w)) for _, mod, params in w.cell.kinds]


def sends(plans: list, w: Window) -> dict:
    """Window block -> the calls that send its commands, kind by kind in
    the mix's order, each kind's in its plan's order."""
    out: dict = {}
    for mod, plan in plans:
        for block, cmd in plan.commands:
            out.setdefault(block, []).append(
                functools.partial(mod.send, cmd, w))
    return out


def read_events(plans: list, w: Window) -> None:
    """After the window: each kind reads what the program recorded."""
    for mod, plan in plans:
        mod.read(plan, w)


def _marker():
    """Set-up's steps on standard error, seconds since the process began."""
    def mark(what: str) -> None:
        print(f"zlbench set-up: {what} at {process_age_s():.2f} s",
              file=sys.stderr, flush=True)
    return mark


def fresh_spans(engine) -> None:
    """Start the engine's span windows at the timed window: a new profiler
    of the engine's own class (it keeps each span's last 2048 samples)."""
    engine.profiler = type(engine.profiler)()


def bounce(s: Session, seconds: float, run: Run, trace_at=None) -> list:
    """Bounce cells: step_blocks back to back in chunks of four drains.
    `trace_at` (seconds into the window, fn(window block)): calls fn once,
    at the first chunk that starts that late."""
    rt = s.rt
    chunk = 4 * rt.bounce_drain_blocks
    frames0 = s.sink.frames
    blocks = 0
    log = []
    t0 = run.t0 = time.perf_counter()
    while True:
        if trace_at and time.perf_counter() - t0 >= trace_at[0]:
            trace_at[1](blocks)
            trace_at = None
        a = time.time_ns()
        rt.step_blocks(chunk)
        log.append(("runtime step_blocks", a, time.time_ns()))
        blocks += chunk
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.blocks = blocks
    run.frames = s.sink.frames - frames0
    return log


def live_blocks(seconds: float, period: float) -> int:
    """The blocks a live window of `seconds` renders."""
    return int(np.ceil(seconds / period))


def live(s: Session, seconds: float, run: Run, by_block: dict,
         trace_at=None) -> list:
    """Live cells: one step_blocks(1) a period, on the benchmark's clock;
    before block i, each call of `by_block[i]` (`sends`) under the
    runtime's lock. `trace_at` as for `bounce`, checked before each
    block's wait."""
    rt = s.rt
    period = run.period_s
    n = live_blocks(seconds, period)
    due = np.empty(n)
    started = np.empty(n)
    woke = []
    first = s.sink.count
    log = []
    t0 = run.t0 = time.perf_counter()
    for i in range(n):
        d = t0 + i * period
        due[i] = d
        if trace_at and time.perf_counter() - t0 >= trace_at[0]:
            trace_at[1](i)
            trace_at = None
        if time.perf_counter() < d:
            a = time.time_ns()
            wait_until(d)
            log.append(("waiting for the period", a, time.time_ns()))
            woke.append(time.perf_counter() - d)
        a = time.time_ns()
        for send in by_block.get(i, ()):
            rt.run_locked(send)
        started[i] = time.perf_counter()
        rt.step_blocks(1)
        log.append(("runtime step_blocks(1)", a, time.time_ns()))
    run.window_s = time.perf_counter() - t0
    run.blocks = n
    run.due = due
    run.started = started
    run.delivered = np.asarray(s.sink.times[first:first + n])
    run.frames = int(len(run.delivered) * run.block_frames)
    step = run.delivered - started
    print("zlbench live: woke after the due time p50/p99/max "
          + " / ".join(f"{x * 1e3:.3f}" for x in np.percentile(
              woke or [0.0], [50, 99, 100]))
          + f" ms over {len(woke)} waits; step_blocks(1) to the sink "
          + "p50/p99/max " + " / ".join(
              f"{x * 1e3:.3f}" for x in np.percentile(step, [50, 99, 100]))
          + " ms", file=sys.stderr, flush=True)
    return log


SPIN_S = 0.0005


def wait_until(t: float) -> None:
    """Sleep until SPIN_S before `t` on the host clock, then yield the
    interpreter until `t`: a sound card's period interrupt wakes its
    callback on time, where a plain sleep can oversleep."""
    left = t - time.perf_counter()
    if left > SPIN_S:
        time.sleep(left - SPIN_S)
    while time.perf_counter() < t:
        time.sleep(0)


def events_for(w: Window, plans: list) -> list:
    """The reference's events in the order they take effect: the loops'
    starts at block 0, frame 0, tick 0, then each event kind's."""
    events = [reference.Start(0, 0, 0, v.clip, v.channel, v.note, v.volume,
                              True) for v in w.session.loops]
    for mod, plan in plans:
        events.extend(mod.events(plan, w))
    return reference.effect_order(events)
