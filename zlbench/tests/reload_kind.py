"""An event kind for the tests alone (no traffic file names it): at one
window block one clip's playback is replaced by a buffer made from the
seed, through the port's synchronous API (`clip.playback_audio = ...;
engine.reload_clip_sound(clip)`), and the sink index of the block it took
effect at is read after the window.

Parameters: `block` (the window block it is sent before), `clip`, `frames`
(the new buffer's length) and `late` (blocks added to the effect block the
reference is told: 0, or a fault, -1 or 1)."""

from __future__ import annotations

import numpy as np

from zlbench import harness, reference

SPAN = 4     # blocks kept from the send on, and the one before it


def plan(params: dict, w) -> harness.Plan:
    rng = np.random.default_rng([w.seed, 60])
    n = int(params["frames"])
    sr = float(w.cell.config["sample_rate"])
    f0 = rng.uniform(110.0, 440.0)
    t = np.arange(n)[:, None] / sr
    audio = (0.2 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28, 2))
             + rng.normal(0.0, 0.02, (n, 2))).astype(np.float32)
    i = int(params["block"])
    cmd = {"clip": int(params["clip"]), "audio": audio, "at": None}
    return harness.Plan([(i, cmd)], set(range(w.first + i - 1,
                                              w.first + i + SPAN)),
                        {"late": int(params.get("late", 0))})


def send(cmd: dict, w) -> None:
    from libzl_tpu_torch.io.wav import AudioData

    port = w.session.port_clips[cmd["clip"]]
    port.playback_audio = AudioData(cmd["audio"].copy(),
                                    w.cell.config["sample_rate"])
    w.session.rt.engine.reload_clip_sound(port)
    # the runtime has delivered every block before this one
    cmd["at"] = w.session.sink.count


def read(plan: harness.Plan, w) -> None:
    plan.state["effect"] = [cmd["at"] for _, cmd in plan.commands]


def events(plan: harness.Plan, w) -> list:
    return [reference.Reload(b + plan.state["late"], cmd["clip"],
                             cmd["audio"])
            for b, (_, cmd) in zip(plan.state["effect"], plan.commands)]
