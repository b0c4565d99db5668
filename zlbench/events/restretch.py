"""restretch: a musician turning a clip's pitch or speed knob while the
sketchpad plays, as the C API sends each value change
(`ClipAudioSource_setPitch` / `ClipAudioSource_setSpeedRatio`:
`set_pitch(v, defer=True)` / `set_speed_ratio(v, defer=True)` under the
runtime's lock). The program re-renders the clip on its render worker and
swaps the new playback buffer in at the start of a later block, which it
records (`AudioEngine.applied_renders`: block, clip, render generation);
the reference reloads the clip there with a buffer rendered by
`zlbench/stretch.py` from the clip's source at the speed and pitch this
kind sent.

Parameters (the mix's `restretch`): `bursts` knob turns, turn k starting
at window second `first_s + every_s * k + U(0, jitter_s)` on one clip that
a loop plays, drawn from the seed; each turn is `steps` value changes
`step_ms` apart, in one direction drawn per turn that reflects at the
control's ends; even turns move `pitch`, odd ones `speed` (each a `step`
within a `range`, from the clip's start, pitch 0 and speed 1). A turn
whose last change could fall within `keep_s` of the window's end is left
out, so every seed sends the same count. The sink keeps each send's block
before it and `keep_s` after it; a render applied outside them fails the
run, as does a program that keeps no record or a stretch backend other
than the configuration's `stretch`, before the window.
"""

from __future__ import annotations

import math

import numpy as np

from zlbench import harness, reference, stretch

# the clips' controls at the start: the program's defaults and the
# upstream's (lib/ClipAudioSource.cpp)
START = {"pitch": 0.0, "speed": 1.0}
CONTROLS = ("pitch", "speed")


def _grid(params: dict, control: str) -> tuple:
    """The control's value at step index i (start + i * step, as a C float
    carries it through the C API) and its least and greatest index."""
    p = params[control]
    start, step = START[control], float(p["step"])
    lo, hi = (round((v - start) / step) for v in p["range"])

    def value(i: int) -> float:
        return float(np.float32(start + i * step))
    return value, lo, hi


def _check_program(w) -> None:
    """Before the window: the program records where each re-render takes
    effect, and renders with the configuration's stretcher."""
    from libzl_tpu_torch.ops.resample import resolve_stretch_backend

    engine = w.session.rt.engine
    if getattr(engine, "applied_renders", None) is None:
        raise RuntimeError(
            "restretch: the program keeps no record of the re-renders it "
            "applies (AudioEngine.applied_renders), so no reload's block "
            "can be known; this cell cannot run on it")
    want = w.cell.config["stretch"]
    got = resolve_stretch_backend("auto")
    if got != want:
        raise RuntimeError(
            f"restretch: the program's stretch backend resolves to {got!r}, "
            f"the configuration states {want!r}")


def plan(params: dict, w) -> harness.Plan:
    _check_program(w)
    rng = np.random.default_rng([w.seed, 70])
    played = sorted({v.clip for v in w.session.loops})
    steps = int(params["steps"])
    step_s = float(params["step_ms"]) / 1e3
    keep_s = float(params["keep_s"])
    grids = {c: _grid(params, c) for c in CONTROLS}
    at = {(c, k): 0 for c in played for k in CONTROLS}   # step indices
    commands = []
    keep = set()
    keep_blocks = math.ceil(keep_s / w.period_s)
    for k in range(int(params["bursts"])):
        t0 = (float(params["first_s"]) + float(params["every_s"]) * k
              + rng.uniform(0.0, float(params["jitter_s"])))
        clip = int(rng.choice(played))
        direction = 1 if rng.integers(0, 2) else -1
        latest = (float(params["first_s"]) + float(params["every_s"]) * k
                  + float(params["jitter_s"]) + (steps - 1) * step_s)
        if latest + keep_s > w.seconds:
            continue
        control = CONTROLS[k % 2]
        value, lo, hi = grids[control]
        for j in range(steps):
            i = at[clip, control] + direction
            if not lo <= i <= hi:
                direction = -direction
                i = at[clip, control] + direction
            at[clip, control] = i
            state = {c: grids[c][0](at[clip, c]) for c in CONTROLS}
            block = int((t0 + j * step_s) // w.period_s)
            commands.append((block, {"clip": clip, "control": control,
                                     "value": value(i), "state": state,
                                     "gen": None}))
            keep.update(range(w.first + block - 1,
                              w.first + block + keep_blocks + 1))
    commands.sort(key=lambda bc: bc[0])
    engine = w.session.rt.engine
    # the engine's block index less the sink's, constant over a live
    # window: one process_block a delivered block
    offset = engine.total_blocks - w.session.sink.count
    return harness.Plan(commands, keep, {"offset": offset,
                                         "seen": len(engine.applied_renders)})


def send(cmd: dict, w) -> None:
    port = w.session.port_clips[cmd["clip"]]
    if cmd["control"] == "pitch":
        port.set_pitch(cmd["value"], defer=True)
    else:
        port.set_speed_ratio(cmd["value"], defer=True)
    cmd["gen"] = port._render_generation


def read(plan: harness.Plan, w) -> None:
    """Each re-render the program applied in the window: the sink block it
    took effect at, and the command whose generation it rendered."""
    engine = w.session.rt.engine
    record = list(engine.applied_renders)[plan.state["seen"]:]
    ids = [p.id for p in w.session.port_clips]
    sent = {(ids[cmd["clip"]], cmd["gen"]): cmd
            for _, cmd in plan.commands if cmd["gen"] is not None}
    applied = []
    for block, clip_id, gen in record:
        cmd = sent.get((clip_id, gen))
        at = block - plan.state["offset"]
        if cmd is None:
            raise RuntimeError(
                f"restretch: the program applied a render no command sent "
                f"(clip id {clip_id}, generation {gen}) at sink block {at}")
        if at not in plan.keep:
            raise RuntimeError(
                f"restretch: the render of clip {cmd['clip']} (generation "
                f"{gen}) took effect at sink block {at}, outside the blocks "
                f"kept for the check")
        applied.append((at, cmd))
    plan.state["applied"] = applied


def events(plan: harness.Plan, w) -> list:
    sr = int(w.cell.config["sample_rate"])
    out = []
    for at, cmd in plan.state["applied"]:
        source = w.session.clips[cmd["clip"]].audio
        audio = stretch.render_playback(source, cmd["state"]["speed"],
                                        cmd["state"]["pitch"], 0.0, sr)
        out.append(reference.Reload(at, cmd["clip"], audio))
    return out
