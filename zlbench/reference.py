"""The plain reference: the sketchpad's master mix worked out again from the
benchmark's own inputs (clips, looped voices, live notes), in NumPy and plain
PyTorch. It imports nothing of the program, of `jax` or of `libzl_tpu`, and
takes nothing the program made.

It re-derives what the program's host derives, block by block, with the
semantics of the Zynthbox sampler (libzl lib/SamplerSynthVoice.cpp, as the
port restates them in engine/voicestate.py's docstring):

- voice claims: a start takes the lowest idle voice of the pool (a full pool
  drops the start); a note-off releases every live voice of its clip,
  channel and note;
- positions: a voice reads its clip at `2^((note - root) / 12)` source
  frames a frame, linearly interpolated between two taps; a frame reads only
  while its whole position lies in [0, frames - 1). Within a block a
  position is the block's anchor plus `j * rate` (whole part in integers,
  the fraction in float32, product and sum rounded on their own), and each
  block's anchor is the last one's end, so the float32 steps the program
  takes are the reference's too;
- beat-quantized loops (a clip of a whole number of beats): the position
  restarts at the loop start on the frame after each loop boundary of the
  musical clock (96 ticks a beat), not when the clip runs out;
- one-shots (live notes): a hard stop at the clip's end, and an exponential
  auto-release starting a release time before it;
- ADSR (juce::ADSR): the configs' envelope starts at its sustain level
  (attack 0; decay 0 or sustain 1); a note-off starts a linear release whose
  rate is fixed at the trigger (a second one re-fixes it from the current
  level); a linear release that reaches 0 ends the voice;
- gain: velocity (or the loop's volume) times the envelope times the clip
  volume; the M/S pan; every voice summed into the master (lanes 0..11),
  then the global strip (dry, pan, mute);
- reloads (`Reload`: a clip's playback swapped for a new buffer, the
  playbackFileChanged path, lib/SamplerSynthSound.cpp:68, as the port's
  engine/voicestate.py::rebase_clip restates it): from the reload's block
  on, clip c reads the new buffer. Its live voices keep their positions and
  stop frames (both are offsets into a playback file whose rate a re-render
  keeps) and read the new length: a read past the new end is silent until
  the voice's loop restart or stop. Later starts of the clip read the new
  buffer; their stop frame and loop length still come from the clip's own
  timing (its source's length), which a reload leaves alone. A reload takes
  effect before any start or stop of its block.

Everything after the positions is float64 here, so the gap to the program
is the program's own rounding. `reference_bank` can round the bank to a
lower precision for the control (bfloat16).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F32 = np.float32
BIG = 1 << 30
SUSTAIN, RELEASE, IDLE = 3, 4, 0
LINEAR, EXPONENTIAL = 0, 1


@dataclasses.dataclass
class Start:
    """A start command: claims a voice at `frame` of block `block`."""

    block: int
    frame: int
    tick: int
    clip: int
    channel: int
    note: int
    volume: float
    looping: bool


@dataclasses.dataclass
class Stop:
    """A note-off: releases the matching live voices at `frame`."""

    block: int
    frame: int
    clip: int
    channel: int
    note: int


@dataclasses.dataclass
class Reload:
    """From block `block` on, clip `clip` reads `audio` (float32 [frames,
    2], made by the benchmark, never by the program)."""

    block: int
    clip: int
    audio: np.ndarray


def effect_order(events: list) -> list:
    """`events` in the order they take effect: by block, a block's reloads
    first, then by frame; stable, so messages of one frame keep the order
    they were sent in."""
    return sorted(events, key=lambda e: (
        e.block, not isinstance(e, Reload), getattr(e, "frame", 0)))


def tick_of_send(block: int, block_frames: int, samples_per_tick: float):
    """A message sent right before `block` plays at the first tick of the
    musical clock at or after that block's first frame: (block, frame, tick)
    where it takes effect."""
    tick = math.ceil(block * block_frames / samples_per_tick - 1e-9)
    while tick * samples_per_tick < block * block_frames:
        tick += 1
    sample = tick * samples_per_tick
    b = int(sample // block_frames)
    return b, int(sample - b * block_frames), tick


class Sketchpad:
    """The reference's voice pool over the clips' frame counts, stepped one
    block at a time."""

    def __init__(self, config: dict, clip_frames: list, num_voices: int):
        self.B = int(config["block_frames"])
        self.sr = float(config["sample_rate"])
        self.bpm = float(config["bpm"])
        # the program's own float expressions for a tick and a beat
        self.spt = 60.0 / (self.bpm * 96) * self.sr
        self.beat_s = 96 * 60_000_000_000 / (self.bpm * 96) / 1e9
        a, d, s, r = (float(x) for x in config["adsr"])
        if a != 0.0 or (d > 0 and s < 1.0):
            raise NotImplementedError("the reference starts every envelope "
                                      "at its sustain level")
        self.sustain = s
        self.release_s = F32(r)
        self.inv_rel = F32(1.0 / (r * self.sr)) if r > 0 else F32(0.0)
        ir = float(self.inv_rel)
        self.rel_log2 = (F32(np.log2(F32(1.0) - self.inv_rel)) if 0 < ir < 1
                         else F32(-200.0) if ir >= 1 else F32(0.0))
        self.root = int(config["root_note"])
        self.clip_volume = F32(config["clip_volume"])
        # each clip's own timing (its stop frame and loop length), and the
        # region of the reference bank it reads now (the clips, then each
        # reload's buffer) with each region's length
        self.frames = np.asarray(clip_frames, np.int64)
        self.region = np.arange(len(clip_frames), dtype=np.int64)
        self.region_frames = [int(n) for n in clip_frames]
        V = num_voices
        self.V = V
        z = lambda dt: np.zeros(V, dt)  # noqa: E731
        self.active = z(bool)
        self.clip = z(np.int64)
        self.channel = z(np.int64)
        self.note = z(np.int64)
        self.looping = z(bool)
        self.bq = z(bool)
        self.loop_ticks = z(np.int64)
        self.next_tick = z(np.int64)
        self.rate_i = z(np.int64)
        self.rate_f = z(F32)
        self.pos_i = z(np.int64)
        self.pos_f = z(F32)
        self.stop = z(np.int64)
        self.length = z(np.int64)
        self.gain = z(F32)
        self.stage = z(np.int64)
        self.env = z(F32)
        self.rel_rate = z(F32)
        self.rel_mode = z(np.int64)
        self.pending_start = np.full(V, -1, np.int64)
        self.pending_release = np.full(V, BIG, np.int64)
        self.block = 0
        self.dropped = 0
        self._calm = None   # (no start, release or one-shot, next restart)

    # -------------------------------------------------------------- events

    def start(self, ev: Start) -> None:
        self._calm = None
        idle = np.flatnonzero(~self.active)
        if idle.size == 0:
            self.dropped += 1
            return
        v = int(idle[0])
        n = int(self.frames[ev.clip])
        seconds = n / self.sr
        beats = seconds / self.beat_s
        ratio = 2.0 ** ((ev.note - self.root) / 12.0)
        self.active[v] = True
        self.clip[v], self.channel[v], self.note[v] = ev.clip, ev.channel, \
            ev.note
        self.rate_i[v] = int(ratio)
        self.rate_f[v] = F32(ratio - int(ratio))
        self.pos_i[v], self.pos_f[v] = 0, 0.0
        self.stop[v] = int(seconds * self.sr)
        self.length[v] = self.region_frames[self.region[ev.clip]]
        self.looping[v] = ev.looping
        self.bq[v] = float(beats) == float(int(beats))
        ticks = int(beats * 96)
        self.loop_ticks[v] = max(ticks, 1)
        self.next_tick[v] = ev.tick + ticks
        self.gain[v] = F32(ev.volume)
        self.stage[v] = SUSTAIN
        self.env[v] = F32(self.sustain)
        self.rel_rate[v] = 0.0
        self.rel_mode[v] = LINEAR
        self.pending_start[v] = ev.frame
        self.pending_release[v] = BIG

    def release(self, ev: Stop) -> None:
        self._calm = None
        m = (self.active & (self.clip == ev.clip)
             & (self.channel == ev.channel) & (self.note == ev.note))
        for v in np.flatnonzero(m):
            self.pending_release[v] = min(self.pending_release[v], ev.frame)

    def reload(self, ev: Reload) -> None:
        """Clip `ev.clip` reads `ev.audio`, the bank's next region, from
        this block on; its live voices keep their positions and stops."""
        self._calm = None
        n = int(ev.audio.shape[0])
        self.region[ev.clip] = len(self.region_frames)
        self.region_frames.append(n)
        self.length[self.active & (self.clip == ev.clip)] = n

    # -------------------------------------------------------------- a block

    def steady(self) -> bool:
        """This block holds no start, release, one-shot, release tail or
        loop restart: every live voice is a sustained loop that only moves
        on (`advance_steady`)."""
        if self._calm is None:
            act = self.active
            calm = (act.any() and not (act & (
                ~self.looping | ~self.bq | (self.stage != SUSTAIN))).any()
                and not (self.pending_start >= 0).any()
                and not (self.pending_release < BIG).any())
            nxt = (float((self.next_tick[act].astype(np.float64)
                          * self.spt).min()) if calm else 0.0)
            self._calm = (calm, nxt)
        calm, nxt = self._calm
        return calm and nxt - self.block * self.B > self.B - 1 + 1e-6

    def steady_plan(self) -> dict:
        """`plan` of a steady block, as far as `read_frames` reads it."""
        V, B = self.V, self.B
        return dict(start=np.zeros(V, np.int64),
                    reset=np.full(V, -1, np.int64),
                    stop=np.full(V, B, np.int64))

    def advance_steady(self) -> None:
        """`advance` of a steady block: each position moves on B frames
        (the same float32 steps)."""
        frac = self.pos_f + F32(self.B) * self.rate_f
        carry = np.floor(frac)
        self.pos_i = self.pos_i + self.B * self.rate_i + carry.astype(
            np.int64)
        self.pos_f = (frac - carry).astype(F32)
        self.block += 1

    def plan(self) -> dict:
        """This block's schedule, from the pool at its start: each voice's
        first frame, loop reset, stop frame, release frame and mode."""
        B = self.B
        act = self.active
        start = np.where(self.pending_start >= 0, self.pending_start, 0)
        posf = self.pos_i.astype(np.float64) + self.pos_f.astype(np.float64)
        rate = self.rate_i.astype(np.float64) + self.rate_f.astype(np.float64)
        rate = np.where(rate > 0, rate, 1.0)
        # beat-quantized loops: the wall-clock boundary at tick next_tick
        # fires on frame ceil(boundary) and the restart lands one frame on
        bq = act & self.looping & self.bq
        diff = self.next_tick.astype(np.float64) * self.spt - self.block * B
        period = np.maximum(self.loop_ticks * self.spt, 1.0)
        wraps = np.where(bq & (diff <= B - 1),
                         np.floor((B - 1 - diff) / period).astype(np.int64)
                         + 1, 0)
        if (wraps > 1).any():
            raise NotImplementedError("more than one loop restart a block")
        reset = np.where(wraps == 1,
                         np.maximum(np.ceil(diff), 0).astype(np.int64) + 1,
                         -1)
        in_block = (reset >= 0) & (reset < B) & (reset >= start)
        if (act & self.looping & ~self.bq).any():
            raise NotImplementedError("loops of a fraction of a beat")
        # one-shots stop where the clip ends
        end = start + np.ceil((self.stop - posf) / rate).astype(np.int64)
        stop = np.clip(np.where(act & ~self.looping, end, B), 0, B)
        rel = np.where(act, self.pending_release, BIG)
        mode = self.rel_mode.copy()
        thr = self.stop - np.float64(self.release_s) * self.sr
        k_ar = np.maximum(
            start + np.ceil((thr - posf) / rate).astype(np.int64) + 1, 0)
        auto = (act & ~self.looping & (self.stage != RELEASE)
                & (self.stage != IDLE) & (k_ar < np.minimum(rel, B)))
        rel = np.where(auto, k_ar, rel)
        mode = np.where(auto, EXPONENTIAL, mode)
        lin = act & (self.stage == RELEASE) & (self.rel_mode == LINEAR) & (
            self.rel_rate > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            death = np.ceil(self.env.astype(np.float64) / np.where(
                self.rel_rate > 0, self.rel_rate, 1.0)).astype(np.int64)
        stop = np.minimum(stop, np.where(lin, np.clip(start + death, 0, B),
                                         B))
        return dict(start=start, reset=np.where(in_block, reset, -1),
                    boundary=wraps.astype(bool) & (reset == B),
                    wraps=wraps, stop=stop,
                    rel=np.clip(rel - start, 0, BIG), mode=mode)

    def _env(self, k, p):
        """Envelope at voice-local frames k ([V, n] int64) of this block,
        float64."""
        env0 = self.env.astype(np.float64)[:, None]
        rel = p["rel"][:, None]
        expo = (p["mode"] == EXPONENTIAL)[:, None]
        log2 = np.float64(self.rel_log2)
        inv = np.float64(self.inv_rel)

        def release_env(e, steps, rate):
            s = np.maximum(steps, 0).astype(np.float64)
            return np.where(expo, e * np.exp2(s * log2),
                            np.maximum(e - s * rate, 0.0))

        new = (release_env(env0, k - rel + 1, env0 * inv) if inv > 0
               else np.zeros_like(env0 * k))
        held = np.where(k < rel, env0, new)
        releasing = release_env(env0, k + 1,
                                self.rel_rate.astype(np.float64)[:, None])
        stage = self.stage[:, None]
        return np.where(stage == IDLE, 0.0,
                        np.where(stage == RELEASE, releasing, held))

    def advance(self, p: dict) -> None:
        """Move the pool past this block."""
        B = self.B
        act = self.active
        start = p["start"]
        reset = p["reset"]
        j = np.where(reset >= 0, B - reset, B - start)
        base_f = np.where(reset >= 0, F32(0.0), self.pos_f)
        base_i = np.where(reset >= 0, 0, self.pos_i)
        frac = base_f + j.astype(F32) * self.rate_f
        carry = np.floor(frac)
        pos_i = base_i + j * self.rate_i + carry.astype(np.int64)
        pos_f = (frac - carry).astype(F32)
        pos_i = np.where(p["boundary"], 0, pos_i)
        pos_f = np.where(p["boundary"], F32(0.0), pos_f)
        self.pos_i = np.where(act, pos_i, self.pos_i)
        self.pos_f = np.where(act, pos_f, self.pos_f).astype(F32)
        n = B - start
        k_last = np.maximum(n - 1, 0)[:, None]
        env_last = self._env(k_last, p)[:, 0].astype(F32)
        released = act & (p["rel"] < n)
        lin = released & (p["mode"] == LINEAR)
        self.rel_rate = np.where(lin, (self.env * self.inv_rel).astype(F32),
                                 self.rel_rate).astype(F32)
        self.rel_mode = np.where(released, p["mode"], self.rel_mode)
        self.stage = np.where(act & released, RELEASE, self.stage)
        self.env = np.where(act, env_last, self.env).astype(F32)
        self.next_tick = self.next_tick + p["wraps"] * self.loop_ticks
        dead = act & ((p["stop"] < B)
                      | ((self.stage == RELEASE) & (self.env <= 0)))
        self.active = act & ~dead
        self.stage = np.where(dead, IDLE, self.stage)
        self.env = np.where(dead, F32(0.0), self.env).astype(F32)
        self.pending_start[:] = -1
        self.pending_release[:] = BIG
        self.block += 1
        self._calm = None

    # ---------------------------------------------------------- the render

    def frames_of_block(self, p: dict):
        """Per voice and frame: (position, alpha float32, valid, gain
        float64), [V, B] each, for this block (before `advance`)."""
        B = self.B
        k = np.arange(B, dtype=np.int64)[None, :]
        start = p["start"][:, None]
        reset = p["reset"][:, None]
        wrapped = (reset >= 0) & (k >= reset)
        j = np.maximum(np.where(wrapped, k - reset, k - start), 0)
        base_f = np.where(wrapped, F32(0.0), self.pos_f[:, None])
        base_i = np.where(wrapped, 0, self.pos_i[:, None])
        frac = base_f + j.astype(F32) * self.rate_f[:, None]
        carry = np.floor(frac)
        pos = base_i + j * self.rate_i[:, None] + carry.astype(np.int64)
        alpha = (frac - carry).astype(F32)
        renders = (self.active[:, None] & (k >= start)
                   & (k < p["stop"][:, None]))
        valid = (renders & (pos >= 0)
                 & (pos < np.maximum(self.length - 1, 1)[:, None]))
        env = self._env(np.maximum(k - start, 0), p)
        gain = (self.gain.astype(np.float64)[:, None] * env
                * np.float64(self.clip_volume))
        return pos, alpha, valid, gain

    def read_frames(self, p: dict) -> int:
        """Distinct bank frames this block's taps read: the union, per bank
        region, of each voice's [first, last + 1] tap range in each of its
        segments."""
        B = self.B
        act = self.active
        if not act.any():
            return 0
        start, reset, stop = p["start"], p["reset"], p["stop"]
        rate = self.rate_i.astype(np.float64) + self.rate_f.astype(np.float64)
        seg0_end = np.where(reset >= 0, reset, stop)
        lo, hi, clip = [], [], []
        for first, last, p0 in (
                (start, seg0_end - 1,
                 self.pos_i + self.pos_f.astype(np.float64)),
                (reset, stop - 1, np.zeros(self.V))):
            m = act & (first >= 0) & (last >= first)
            lo_v = np.floor(p0)
            hi_v = np.floor(p0 + (last - first) * rate) + 1
            lo_v = np.maximum(lo_v, 0)
            hi_v = np.minimum(hi_v, self.length - 1)
            m &= hi_v >= lo_v
            lo.append(lo_v[m])
            hi.append(hi_v[m])
            clip.append(self.clip[m])
        lo = np.concatenate(lo)
        hi = np.concatenate(hi)
        clip = np.concatenate(clip)
        if lo.size == 0:
            return 0
        off = region_offsets(self.region_frames)[self.region[clip]]
        lo, hi = lo + off, hi + off
        order = np.argsort(lo, kind="stable")
        lo, hi = lo[order], hi[order]
        reach = np.maximum.accumulate(hi)
        new = np.ones(lo.size, bool)
        new[1:] = lo[1:] > reach[:-1]
        run = np.cumsum(new) - 1
        run_lo = lo[new]
        run_hi = np.zeros(run_lo.size)
        np.maximum.at(run_hi, run, hi)
        return int((run_hi - run_lo + 1).sum())


def render(pad: Sketchpad, p: dict, bank, offsets, strip0,
           device) -> torch.Tensor:
    """This block's master [B, 2] float64 from the reference bank (`bank`
    [frames, 2] on `device`, in the precision the comparison asks for;
    `offsets` each region's first row; a voice reads its clip's current
    region)."""
    pos, alpha, valid, gain = pad.frames_of_block(p)
    act = np.flatnonzero(pad.active)
    B = pad.B
    if act.size == 0:
        return torch.zeros((B, 2), dtype=torch.float64, device=device)
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a[act]),  # noqa: E731
                                  device=dev)
    n = t(pad.length)[:, None]
    pos_t = t(pos)
    base = torch.as_tensor(offsets, device=dev)[
        t(pad.region[pad.clip])][:, None]
    i0 = base + torch.minimum(torch.clamp_min(pos_t, 0), n - 1)
    i1 = base + torch.minimum(torch.clamp_min(pos_t + 1, 0), n - 1)
    a = t(alpha).double()
    tap0 = bank[i0].double()   # [v, B, 2]
    tap1 = bank[i1].double()
    g = t(gain) * t(valid).double()
    x = (tap0 * (1.0 - a)[..., None] + tap1 * a[..., None]) * g[..., None]
    l, r = x[..., 0], x[..., 1]
    pan = torch.zeros_like(g)   # clip pan: 0 (the config's)
    mid = 0.5 * (l + r)
    side = l - r
    out_l = 0.5 * (1.0 + pan) * mid + side
    out_r = 0.5 * (1.0 - pan) * mid - side
    master = torch.stack([out_l.sum(0), out_r.sum(0)], dim=-1)
    dry, pan0, muted = strip0
    gate = 1.0 - muted
    scale = torch.tensor([min(1.0 - pan0, 1.0) * gate,
                          min(1.0 + pan0, 1.0) * gate],
                         dtype=torch.float64, device=dev)
    return master * scale * dry


def region_offsets(frames: list) -> np.ndarray:
    """Each bank region's first row."""
    return np.concatenate([[0], np.cumsum(frames)[:-1]]).astype(np.int64)


def bank_buffers(clips: list, events: list) -> list:
    """The reference bank's regions: the clips, then the buffer of each
    reload in `events` (in effect order), the order `Sketchpad.reload`
    numbers them in."""
    return list(clips) + [e.audio for e in events if isinstance(e, Reload)]


def reference_bank(buffers, device, lower: bool = False):
    """The buffers (`bank_buffers`) stacked into one [frames, 2] tensor on
    `device` in float32 as the config states (with `lower`, for the
    control, every region alike rounded to bfloat16 and read back as
    float32), and each region's first row."""
    offsets = region_offsets([b.shape[0] for b in buffers])
    bank = torch.as_tensor(np.concatenate(buffers, axis=0), device=device)
    if lower:
        bank = bank.to(torch.bfloat16).float()
    return bank, offsets
